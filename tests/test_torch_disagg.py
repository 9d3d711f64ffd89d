"""Disaggregated prefill/decode in the port (serving/disagg.py and the
batcher's export/remote-admit half), held against the JAX package at the
2-layer float32 config of tests/_torch_sched.py on the CPU.

Mirrors tests/test_disagg.py, the failover cases of
tests/test_fault_tolerance.py and the remote-admit refusal of
tests/test_pressure.py: the SKV1 frames of the two packages are
byte-identical and each decodes the other's (bfloat16 included, read
without ml_dtypes), a port export equals a JAX export (first token and
lane key exactly, the slab within 1e-5), remote admits give the JAX
streams (greedy against ``generate``, seeded against the JAX batcher's
own disaggregated stream, every JAX reference request run alone), and
the server roles, transports and failover behave as the JAX ones.
"""

import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu.serving import disagg as jax_disagg
from seldon_core_tpu_torch.resilience import FaultRule, KVFaults
from seldon_core_tpu_torch.serving import disagg
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher
from seldon_core_tpu_torch.serving.disagg import (
    AllPeersDown,
    ChecksumError,
    DisaggError,
    FailoverKVClient,
    PeerBusy,
    PrefillTransportServer,
    PrefixGone,
    TcpKVClient,
    TierMiss,
    TruncatedStream,
    WeightVersionMismatch,
    decode_slab,
    encode_slab,
    make_failover,
)
from seldon_core_tpu_torch.serving.pressure import PressureRefused

from _torch_engine import make_model_dir
from _torch_sched import BASE, JaxBatcher, JaxReference, make_models, port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEM = list(range(1, 17))


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("disagg-llm"))


def wire(meta, slab, chunk_bytes=64, pkg=disagg):
    return b"".join(bytes(f) for f in pkg.encode_slab(meta, slab, chunk_bytes=chunk_bytes))


def unwire(raw):
    return decode_slab(io.BytesIO(raw).read)


def _slab(dtype, seed=0, w=8):
    rs = np.random.RandomState(seed)
    shape = (2, 1, 2, w, 4)
    return {name: torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
            for name in ("k", "v")}


def _jax_view(t):
    """The same slab half as the JAX package holds it (ml_dtypes
    bfloat16 for a bfloat16 tensor)."""
    import ml_dtypes

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# -- the codec ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_frames_byte_identical_and_cross_decode(dtype):
    slab = _slab(dtype)
    jslab = {name: _jax_view(t) for name, t in slab.items()}
    meta = {"tokens": [1, 2, 3], "first_token": 7, "rng_key": [0, 9], "weight_version": 0}
    frames = [bytes(f) for f in encode_slab(meta, slab, chunk_bytes=40)]
    jframes = list(jax_disagg.encode_slab(meta, jslab, chunk_bytes=40))
    assert frames == jframes
    # the port's decode of the JAX frames, and the JAX decode of the port's
    got_meta, got = unwire(b"".join(jframes))
    assert got_meta["slab_dtype"] == str(dtype).replace("torch.", "")
    for name in ("k", "v"):
        assert got[name].dtype == dtype and torch.equal(got[name], slab[name])
    jmeta, jgot = jax_disagg.decode_slab(io.BytesIO(b"".join(frames)).read)
    assert jmeta == got_meta
    for name in ("k", "v"):
        np.testing.assert_array_equal(jgot[name], jslab[name])
    # numpy input (the JAX package's own arrays) frames the same bytes
    assert wire(meta, jslab) == wire(meta, slab)


_NO_ML_DTYPES = r'''
import io, sys
sys.modules["ml_dtypes"] = None  # any import of it fails
import torch
from seldon_core_tpu_torch.serving.disagg import decode_slab, encode_slab
k = torch.arange(2 * 2 * 3 * 4, dtype=torch.float32).reshape(2, 1, 2, 3, 4).bfloat16()
raw = b"".join(bytes(f) for f in encode_slab({"tokens": [1]}, {"k": k, "v": -k}))
meta, got = decode_slab(io.BytesIO(raw).read)
assert meta["slab_dtype"] == "bfloat16" and got["k"].dtype == torch.bfloat16
assert torch.equal(got["k"], k) and torch.equal(got["v"], -k)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("seldon_core_tpu.") or m == "seldon_core_tpu")
print("OK" if not bad else bad)
'''


def test_codec_reads_bf16_without_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"


def _corrupt_payload(raw):
    raw = bytearray(raw)
    raw[len(raw) // 2] ^= 0xFF
    return bytes(raw)


def _corrupt_header(raw):
    raw = bytearray(raw)
    ix = raw.index(b"1234")  # the first_token digits inside the header
    raw[ix] = ord("9")
    return bytes(raw)


@pytest.mark.parametrize("mangle,err,match", [
    (_corrupt_payload, ChecksumError, "checksum"),
    (_corrupt_header, ChecksumError, "header"),
    (lambda raw: raw[:2], TruncatedStream, "ended"),
    (lambda raw: raw[: len(raw) // 3], TruncatedStream, "ended"),
    (lambda raw: raw[:-3], TruncatedStream, "ended"),
    (lambda raw: b"XXXX" + raw[4:], DisaggError, "magic"),
])
def test_codec_refusals_typed(mangle, err, match):
    raw = wire({"tokens": [1], "first_token": 1234}, _slab(torch.float32))
    for pkg_decode in (decode_slab, jax_disagg.decode_slab):
        exc = err if pkg_decode is decode_slab else getattr(jax_disagg, err.__name__)
        with pytest.raises(exc, match=match):
            pkg_decode(io.BytesIO(mangle(raw)).read)


@pytest.mark.parametrize("exc", [WeightVersionMismatch("stale"), PeerBusy("full"),
                                 TierMiss("cold"), DisaggError("boom")])
def test_codec_error_frames_typed(exc):
    raw = disagg.encode_error(exc)
    assert raw == jax_disagg.encode_error(getattr(jax_disagg, type(exc).__name__)(str(exc)))
    with pytest.raises(type(exc), match=str(exc)):
        decode_slab(io.BytesIO(raw).read)
    assert disagg.encode_pong() == jax_disagg.encode_pong()


@pytest.mark.parametrize("kind,seed", [("corrupt", 3), ("truncate", 3), ("drop", 5)])
def test_kv_faults_hit_the_real_codec(kind, seed):
    raw = wire({"tokens": [1, 2]}, _slab(torch.float32))
    kv = KVFaults([FaultRule(**{f"kv_{kind}_rate": 1.0})], seed=seed, addr="p:1")
    with pytest.raises(DisaggError):
        decode_slab(kv.wrap_read(io.BytesIO(raw).read))
    assert kv.injected[kind] == 1
    # no byte rule: the reader passes through untouched
    read = io.BytesIO(raw).read
    assert KVFaults([FaultRule(kv_connect_refused_rate=1.0)], 1, "p").wrap_read(read) is read


# -- export and remote admit ----------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8])
def test_export_matches_jax(models, chunk):
    """The same prompt through both packages' export_prefill: the first
    token and lane key equal, the slab within 1e-5, whole and chunked
    (a 24-token prompt in the 32 bucket, chunks of 8)."""
    jm, jp = models[0], models[1]
    pf = port(models, slots=1, prefill_chunk=chunk)
    jb = JaxBatcher(jm, jp, **{**BASE, "slots": 1, "prefill_chunk": chunk})
    try:
        for prompt, kw in ((list(range(1, 25)), dict(temperature=0.8, seed=5)),
                           ([3, 17, 42, 99, 7], dict(temperature=0.0)),
                           (SYSTEM + [60, 61], dict(covered_len=16))):
            meta, slab = pf.export_prefill(prompt, max_new_tokens=8, **kw)
            jmeta, jslab = jb.export_prefill(prompt, max_new_tokens=8, **kw)
            for key in ("first_token", "rng_key", "tokens", "prompt_hash", "bucket",
                        "covered_len", "n_tokens", "layout", "weight_version"):
                assert meta[key] == jmeta[key], key
            assert list(meta) == list(jmeta)  # same header key order on the wire
            for name in ("k", "v"):
                np.testing.assert_allclose(slab[name].numpy(), np.asarray(jslab[name]),
                                           atol=1e-5, rtol=0)
        assert pf.stats["kv_exports"] == 3
        assert pf.stats["prefill_chunks"] == jb.stats["prefill_chunks"]
    finally:
        pf.close()
        jb.close()


GREEDY = [([3, 17, 42, 99, 7], dict(max_new_tokens=10)),
          (list(range(1, 25)), dict(max_new_tokens=8)),
          ([9, 8, 7, 6], dict(max_new_tokens=12, eos_id=5))]
SAMPLED = [([3, 17, 42, 99, 7], dict(max_new_tokens=10, temperature=0.8, seed=11)),
           ([1, 2, 3], dict(max_new_tokens=9, temperature=1.1, seed=4))]


def _jax_disagg_stream(models, reqs):
    """The JAX batcher's own disaggregated streams, each request alone."""
    jm, jp = models[0], models[1]
    pf = JaxBatcher(jm, jp, **{**BASE, "slots": 1})
    dec = JaxBatcher(jm, jp, **BASE)
    try:
        out = []
        for p, kw in reqs:
            meta, slab = pf.export_prefill(p, **kw)
            out.append(dec.admit_remote(slab, meta).result(timeout=300))
        return out
    finally:
        pf.close()
        dec.close()


def test_remote_admit_streams_equal_jax(models, jax_ref):
    pf = port(models, slots=1)
    dec = port(models)
    try:
        # greedy: through the wire codec, admitted concurrently
        futs = []
        for p, kw in GREEDY:
            meta, slab = unwire(wire(*pf.export_prefill(p, **kw)))
            futs.append(dec.admit_remote(slab, meta))
        assert [f.result(timeout=120) for f in futs] == jax_ref(GREEDY)
        # seeded: the JAX batcher's own disaggregated streams
        futs = [dec.admit_remote(*reversed(pf.export_prefill(p, **kw))) for p, kw in SAMPLED]
        assert [f.result(timeout=120) for f in futs] == _jax_disagg_stream(models, SAMPLED)
        # a JAX-made slab admits into the port's decode pool
        jm, jp = models[0], models[1]
        jpf = JaxBatcher(jm, jp, **{**BASE, "slots": 1})
        try:
            p, kw = GREEDY[0]
            meta, slab = unwire(wire(*jpf.export_prefill(p, **kw), pkg=jax_disagg))
        finally:
            jpf.close()
        assert dec.admit_remote(slab, meta).result(timeout=120) == jax_ref(GREEDY[:1])[0]
        assert dec.stats["kv_imports"] == len(GREEDY) + len(SAMPLED) + 1
        assert dec.stats["prefill_steps"] == 0  # no prompt was prefilled here
    finally:
        pf.close()
        dec.close()


def test_remote_admit_prefix_dedup_counted(models, jax_ref):
    """Suffix-only transfer over a decode-side radix hit: the streams are
    the unified ones (JAX, cache on), ``cache_hit_tokens`` is reported
    and ``kv_transfer_bytes_saved`` counts the skipped bytes."""
    p1, p2 = SYSTEM + [50, 51, 52], SYSTEM + [60, 61]
    cache = dict(prefix_cache_hbm_bytes=1 << 20)
    reqs = [(p1, dict(max_new_tokens=8)), (p2, dict(max_new_tokens=8))]
    jm, jp = models[0], models[1]
    uni = JaxBatcher(jm, jp, **{**BASE, **cache})
    try:
        want = [uni.submit(p, **kw).result(timeout=300) for p, kw in reqs]
    finally:
        uni.close()
    pf = port(models, slots=1)
    dec = port(models, **cache)
    try:
        def remote(p):
            covered = dec.remote_covered_len(p)
            meta, slab = pf.export_prefill(p, max_new_tokens=8, covered_len=covered)
            fut = dec.admit_remote(*reversed(unwire(wire(meta, slab))))
            return fut.result(timeout=120), fut.gen_request, covered

        got1, _req1, c1 = remote(p1)
        assert got1 == want[0] and c1 == 0
        deadline = time.monotonic() + 10.0
        while dec.remote_covered_len(p2) == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        got2, req2, c2 = remote(p2)
        assert got2 == want[1]
        assert c2 >= 16 and req2.cache_hit_tokens == c2
        assert dec.stats["kv_transfer_bytes_saved"] == c2 * dec._slab_token_bytes
        assert dec.stats["kv_import_bytes"] < 2 * pf.stats["kv_export_bytes"]
    finally:
        pf.close()
        dec.close()


def test_remote_admit_refusals_leave_no_lane(models):
    """A stale weight version, a wrong-shape slab, a truncated stream and
    a bad rng key are refused typed before any lane state exists; a
    suffix-only slab without a donor is PrefixGone (at admit without a
    cache, at insert time with one); the pool keeps serving."""
    pf = port(models, slots=1)
    dec = port(models)
    dec_cache = port(models, prefix_cache_hbm_bytes=1 << 20)
    try:
        meta, slab = pf.export_prefill([9, 8, 7], max_new_tokens=6)
        with pytest.raises(WeightVersionMismatch):
            dec.admit_remote(slab, {**meta, "weight_version": 1})
        raw = wire(meta, slab)
        with pytest.raises(TruncatedStream):
            unwire(raw[:-5])
        bad = {name: t[:, :, :, :-1] for name, t in slab.items()}
        with pytest.raises(DisaggError, match="shape"):
            dec.admit_remote(bad, meta)
        with pytest.raises(DisaggError, match="dtype"):
            dec.admit_remote({n: t.double() for n, t in slab.items()}, meta)
        with pytest.raises(DisaggError, match="uint32"):
            dec.admit_remote(slab, {**meta, "rng_key": [-1, 3]})
        with pytest.raises(DisaggError, match="hash"):
            dec.admit_remote(slab, {**meta, "tokens": [9, 8, 6]})
        assert not dec._active and dec.stats["kv_imports"] == 0
        got = dec.admit_remote(slab, meta).result(timeout=120)
        assert got == dec.generate([9, 8, 7], max_new_tokens=6)
        p = list(range(1, 20))
        meta, slab = pf.export_prefill(p, max_new_tokens=6, covered_len=16)
        with pytest.raises(PrefixGone):
            dec.admit_remote(slab, meta)
        fut = dec_cache.admit_remote(slab, meta)
        with pytest.raises(PrefixGone):
            fut.result(timeout=120)
        assert not dec_cache._active
    finally:
        for b in (pf, dec, dec_cache):
            b.close()


def test_remote_admit_under_pressure_refused(models):
    """A decode pool over its high watermark refuses the remote admit
    with PressureRefused (503 + retry_after_s) before any lane state."""
    pf = port(models, slots=1)
    dec = port(models, slots=2, hbm_ledger_bytes=1 << 40)
    try:
        meta, slab = pf.export_prefill([5, 6, 7], max_new_tokens=8)
        f = dec.submit([1, 2, 3], max_new_tokens=58)
        dec._pressure.set_budget(256)
        refusal, admitted = None, []
        while not f.done():
            try:
                admitted.append(dec.admit_remote(slab, meta))
            except PressureRefused as e:
                refusal = e
                break
            time.sleep(0.002)
        assert refusal is not None, "no refusal before the lane completed"
        assert refusal.status == 503 and refusal.retry_after_s >= 1.0
        assert dec.stats["pressure_refused"] >= 1
        dec._pressure.restore_budget()
        f.result(timeout=120)
        for a in admitted:
            a.result(timeout=120)
        assert dec.admit_remote(slab, meta).result(timeout=120)[:3] == [5, 6, 7]
    finally:
        pf.close()
        dec.close()


def test_disagg_with_speculation_refused(models, model_dir):
    from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="speculative"):
            GenerateServer(model_uri=model_dir, device="cpu", role=role,
                           speculate_tokens=3, draft_layers=1)
    with pytest.raises(ValueError, match="role"):
        GenerateServer(model_uri=model_dir, device="cpu", role="both")
    cfg = dataclasses.asdict(models[2].cfg)
    cfg["n_layers"] = 1
    draft = TorchLM(**cfg)
    spec = ContinuousBatcher(models[2], models[3], **BASE, draft_model=draft,
                             draft_params=models[3], speculate_tokens=2)
    pf = port(models, slots=1)
    try:
        meta, slab = pf.export_prefill([1, 2, 3], max_new_tokens=4)
        with pytest.raises(DisaggError, match="speculative"):
            spec.admit_remote(slab, meta)
    finally:
        spec.close()
        pf.close()


# -- server roles --------------------------------------------------------------------


def _server(model_dir, **kw):
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    s = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2, **kw)
    s.load()
    return s


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_roles_loopback_and_tcp_identical(model_dir):
    from seldon_core_tpu_torch import microservice

    uni = _server(model_dir)
    kv_port = _free_port()
    pf = _server(model_dir, role="prefill", kv_port=kv_port)
    dec_lo = _server(model_dir, role="decode")
    dec_lo.set_peer(pf)
    # typed parameters, as PREDICTIVE_UNIT_PARAMETERS carries them
    params = [{"name": "model_uri", "value": model_dir, "type": "STRING"},
              {"name": "device", "value": "cpu", "type": "STRING"},
              {"name": "slots", "value": "2", "type": "INT"},
              {"name": "role", "value": "decode", "type": "STRING"},
              {"name": "peer", "value": f"127.0.0.1:{kv_port}", "type": "STRING"}]
    dec_tcp = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.generateserver.GenerateServer", json.dumps(params))
    dec_tcp.load()
    try:
        assert pf._kv_server.port == kv_port and pf.batcher.slots == 1
        body = {"prompt_tokens": [[5, 6, 7, 8], [9, 10, 11]], "max_new_tokens": 6,
                "temperature": 0.7, "seed": 3}
        ref = uni.predict(dict(body), [])["tokens"]
        assert dec_lo.predict(dict(body), [])["tokens"] == ref
        assert dec_tcp.predict(dict(body), [])["tokens"] == ref
        with pytest.raises(RuntimeError, match="prefill"):
            pf.predict(dict(body), [])
        with pytest.raises(RuntimeError, match="prefill"):
            pf.stream({"prompt_tokens": [1, 2], "max_new_tokens": 2})
        # the streamed twin over both transports
        for dec in (dec_lo, dec_tcp):
            handle = dec.stream({"prompt_tokens": [5, 6, 7, 8], "max_new_tokens": 6,
                                 "temperature": 0.7, "seed": 3})
            spans, final = [], None
            for chunk in handle.chunks:
                if chunk.get("done"):
                    final = chunk["tokens"]
                else:
                    spans.extend(chunk["tokens"])
            assert final == ref[0] and final[4:] == spans
        keys = {m["key"] for m in dec_lo.metrics()}
        assert {"gen_kv_import_slabs", "gen_kv_import_bytes"} <= keys
        assert "gen_kv_export_slabs" in {m["key"] for m in pf.metrics()}
        assert pf.batcher.stats["kv_exports"] == 6
        assert pf.batcher._thread is None  # no scheduler loop on a prefill role
    finally:
        for s in (uni, pf, dec_lo, dec_tcp):
            s.close()


def test_prefill_listener_sheds_over_capacity(model_dir):
    pf = _server(model_dir, role="prefill")
    listener = PrefillTransportServer(pf, port=0, host="127.0.0.1", max_inflight=1)
    client = TcpKVClient(f"127.0.0.1:{listener.port}")
    try:
        assert client.probe()
        assert listener._slots.acquire(blocking=False)  # hold the one slot
        try:
            with pytest.raises(PeerBusy, match="capacity"):
                client.prefill({"tokens": [1, 2, 3], "max_new_tokens": 4})
            assert client.probe()  # busy is not dead: pings skip the slots
        finally:
            listener._slots.release()
        meta, slab = client.prefill({"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert meta["n_tokens"] == 3 and slab["k"].shape[3] == pf.batcher._bucket(3)
    finally:
        listener.close()
        pf.close()
    with pytest.raises(DisaggError, match="unreachable"):
        TcpKVClient("127.0.0.1:1").prefill({"tokens": [1, 2, 3]})


def test_failover_ejects_and_readmits_under_kv_faults(model_dir, monkeypatch):
    """A SELDON_FAULTS rule corrupting every transfer of one peer: its
    transfer is refused by the codec's checksum, the peer ejected, the
    request retried on the next peer with the unified stream; with the
    fault gone the peer probes back in after its backoff."""
    uni = _server(model_dir)
    pf1 = _server(model_dir, role="prefill")
    pf2 = _server(model_dir, role="prefill")
    rule = {"unit": f"kv:loopback:{id(pf1):x}", "kv_corrupt_rate": 1.0}
    monkeypatch.setenv("SELDON_FAULTS", json.dumps({"seed": 3, "rules": [rule]}))
    dec = _server(model_dir, role="decode", peer_eject_backoff_s=0.05)
    dec.set_peer([pf1, pf2])
    body = {"prompt_tokens": [[5, 6, 7, 8]], "max_new_tokens": 6}
    try:
        ref = uni.predict(dict(body), [])["tokens"]
        assert dec.predict(dict(body), [])["tokens"] == ref
        peers = dec._kv_client.peers
        assert peers[0].transport._fault.injected["corrupt"] == 1
        assert dec.batcher.stats["peer_ejections"] == 1 and not peers[0].healthy
        assert pf2.batcher.stats["kv_exports"] == 1
        peers[0].transport._fault = None
        time.sleep(0.1)
        for _ in range(2):
            assert dec.predict(dict(body), [])["tokens"] == ref
        assert dec.batcher.stats["peer_readmissions"] == 1 and peers[0].healthy
        assert pf1.batcher.stats["kv_exports"] >= 1
        assert "gen_peer_ejections" in {m["key"] for m in dec.metrics()}
    finally:
        for s in (uni, pf1, pf2, dec):
            s.close()


def test_all_peers_down_degrades_to_local_prefill(model_dir):
    """The only prefill peer dies: requests (unary and streamed) are
    served by a local prefill with the unified streams, counted in
    degraded_local_prefill."""
    uni = _server(model_dir)
    pf = _server(model_dir, role="prefill")
    dec = _server(model_dir, role="decode", peer_eject_backoff_s=30.0)
    dec.set_peer(pf)
    body = {"prompt_tokens": [[5, 6, 7, 8]], "max_new_tokens": 6}
    try:
        ref = uni.predict(dict(body), [])["tokens"]
        assert dec.predict(dict(body), [])["tokens"] == ref
        pf.close()
        for _ in range(2):
            assert dec.predict(dict(body), [])["tokens"] == ref
        handle = dec.stream({"prompt_tokens": [5, 6, 7, 8], "max_new_tokens": 6})
        assert [c for c in handle.chunks if c.get("done")][0]["tokens"] == ref[0]
        st = dec.batcher.stats
        assert st["degraded_local_prefill"] >= 3 and st["peer_ejections"] == 1
        assert "gen_degraded_local_prefill" in {m["key"] for m in dec.metrics()}
    finally:
        for s in (uni, dec):
            s.close()


# -- the failover layer over stub transports -----------------------------------------


class _StubPeer:
    def __init__(self, addr, fail=None, probe_ok=True):
        self.addr, self.name = addr, "stub"
        self.fail, self.probe_ok = fail, probe_ok
        self.calls = self.probes = 0

    def prefill(self, request, deadline_s=None):
        self.calls += 1
        if self.fail is not None:
            raise self.fail
        return {"peer": self.addr}, {}

    def probe(self, timeout_s=2.0):
        self.probes += 1
        return self.probe_ok

    def close(self):
        pass


def test_failover_retries_once_and_ejects():
    dead, good = _StubPeer("a:1", fail=DisaggError("unreachable")), _StubPeer("b:2")
    ejected = []
    fc = FailoverKVClient([dead, good], eject_backoff_s=60.0,
                          on_eject=lambda addr, why: ejected.append(addr))
    assert fc.prefill({})[0]["peer"] == "b:2"
    assert ejected == ["a:1"] and fc.healthy_count() == 1
    for _ in range(3):
        assert fc.prefill({})[0]["peer"] == "b:2"
    assert dead.calls == 1


def test_failover_all_peers_down_typed():
    peers = [_StubPeer(a, fail=DisaggError("down"), probe_ok=False) for a in ("a:1", "b:2")]
    fc = FailoverKVClient(peers, eject_backoff_s=60.0)
    with pytest.raises(DisaggError):
        fc.prefill({})  # both tried, both ejected
    with pytest.raises(AllPeersDown):
        fc.prefill({})
    assert fc._backoff_s(10_000) == 30.0  # the exponent is clamped


def test_failover_busy_and_request_errors_never_eject():
    busy, good = _StubPeer("a:1", fail=PeerBusy("full")), _StubPeer("b:2")
    fc = FailoverKVClient([busy, good], eject_backoff_s=60.0)
    for _ in range(4):
        assert fc.prefill({})[0]["peer"] == "b:2"
    assert fc.healthy_count() == 2
    all_busy = FailoverKVClient([_StubPeer("a:1", fail=PeerBusy("x")),
                                 _StubPeer("b:2", fail=PeerBusy("x"))])
    with pytest.raises(PeerBusy):
        all_busy.prefill({})
    for exc in (WeightVersionMismatch("stale"), PrefixGone("evicted"), ValueError("bad")):
        peer = _StubPeer("a:1", fail=exc)
        fc = FailoverKVClient([peer, _StubPeer("b:2")], eject_backoff_s=60.0)
        with pytest.raises(type(exc)):
            fc.prefill({})
        assert fc.healthy_count() == 2 and peer.calls == 1
    fc = make_failover("127.0.0.1:9001, 127.0.0.1:9002")
    assert [p.addr for p in fc.peers] == ["127.0.0.1:9001", "127.0.0.1:9002"]


def test_engine_metrics_kv_transfer_series():
    from seldon_core_tpu.graph.engine_metrics import MetricsRegistry as JaxRegistry
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry

    metrics = [
        {"type": "COUNTER", "key": "gen_kv_export_bytes", "value": 100},
        {"type": "COUNTER", "key": "gen_kv_import_bytes", "value": 80},
        {"type": "COUNTER", "key": "gen_kv_import_slabs", "value": 2},
        {"type": "COUNTER", "key": "gen_kv_transfer_bytes_saved", "value": 20},
        {"type": "COUNTER", "key": "gen_peer_ejections", "value": 1},
        {"type": "COUNTER", "key": "gen_peer_readmissions", "value": 1},
        {"type": "COUNTER", "key": "gen_degraded_local_prefill", "value": 3},
        {"type": "COUNTER", "key": "gen_pressure_refused", "value": 2},
    ]
    regs = [MetricsRegistry(), JaxRegistry()]
    for reg in regs:
        reg.record_custom(metrics, {"deployment": "d"})
    for name, labels in (
            ("seldon_engine_kv_transfer_bytes", {"direction": "export"}),
            ("seldon_engine_kv_transfer_bytes", {"direction": "import"}),
            ("seldon_engine_kv_transfer_slabs", {"direction": "import"}),
            ("seldon_engine_kv_transfer_bytes_saved", {}),
            ("seldon_engine_peer_ejections", {}),
            ("seldon_engine_peer_readmissions", {}),
            ("seldon_engine_degraded_local_prefill", {}),
            ("seldon_engine_pressure_refused", {})):
        want = {**labels, "deployment": "d"}
        assert regs[0].counter_total(name, want) == regs[1].counter_total(name, want) > 0
    assert ('seldon_engine_kv_transfer_bytes{deployment="d",direction="export"} 100'
            in regs[0].expose())
