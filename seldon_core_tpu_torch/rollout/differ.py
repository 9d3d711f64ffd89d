"""Response divergence diffing for shadow mirroring.

Counterpart of ``seldon_core_tpu/rollout/differ.py``.

A mirrored request produces two responses — the primary's (served to the
caller) and the shadow's (discarded). The differ turns the pair into a
small verdict dict the mirror feeds into the
``seldon_rollout_divergence`` counter:

* **generate** responses (``jsonData`` carrying ``tokens``): token-level
  comparison — the first mismatching position and the mismatch count per
  sequence. Greedy decoding is deterministic, so ANY token drift between
  two predictors claiming the same weights is a real signal (wrong
  checkpoint, different sampling config, corrupted cache).
* **predict** responses (``data`` ndarray/tensor): numeric tolerance
  (``atol``/``rtol``) — two model versions legitimately differ in float
  noise; the tolerance separates noise from behavior change.
* anything else: structural equality of the payload.

``meta`` is stripped before comparison — puids, per-request metrics and
requestPath legitimately differ between two engines.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _payload(response: Dict[str, Any]) -> Dict[str, Any]:
    """The comparable part of an engine response (everything but meta)."""
    if not isinstance(response, dict):
        return {"value": response}
    return {k: v for k, v in response.items() if k != "meta"}


def _token_lists(jd: Dict[str, Any]):
    toks = jd.get("tokens")
    if toks is None:
        return None
    if toks and isinstance(toks[0], (int, float)):
        toks = [toks]
    return [list(map(int, t)) for t in toks]


def _diff_tokens(a, b) -> Dict[str, Any]:
    diverged = False
    mismatch_tokens = 0
    first = None
    if len(a) != len(b):
        diverged = True
    for sa, sb in zip(a, b):
        n = max(len(sa), len(sb))
        for i in range(n):
            ta = sa[i] if i < len(sa) else None
            tb = sb[i] if i < len(sb) else None
            if ta != tb:
                mismatch_tokens += 1
                if first is None:
                    first = i
        if len(sa) != len(sb) or mismatch_tokens:
            diverged = True
    return {
        "kind": "generate",
        "diverged": diverged,
        "mismatch_tokens": mismatch_tokens,
        "first_mismatch": first,
    }


def _tensor(data: Dict[str, Any]):
    if "ndarray" in data:
        return np.asarray(data["ndarray"], dtype=np.float64)
    if "tensor" in data:
        t = data["tensor"]
        return np.asarray(t.get("values", []), dtype=np.float64)
    return None


def diff_responses(
    primary: Dict[str, Any],
    shadow: Dict[str, Any],
    atol: float = 1e-5,
    rtol: float = 1e-3,
) -> Dict[str, Any]:
    """Compare a primary and a mirrored shadow response; returns
    ``{"kind", "diverged", ...}``. Never raises — a malformed pair is a
    divergence of kind "opaque" (the shadow answered something the
    primary's schema can't even be compared to)."""
    try:
        p, s = _payload(primary), _payload(shadow)
        pjd, sjd = p.get("jsonData"), s.get("jsonData")
        if isinstance(pjd, dict) and isinstance(sjd, dict):
            ptoks, stoks = _token_lists(pjd), _token_lists(sjd)
            if ptoks is not None and stoks is not None:
                return _diff_tokens(ptoks, stoks)
        pt = _tensor(p.get("data") or {}) if isinstance(p.get("data"), dict) else None
        st = _tensor(s.get("data") or {}) if isinstance(s.get("data"), dict) else None
        if pt is not None and st is not None:
            if pt.shape != st.shape:
                return {
                    "kind": "predict", "diverged": True,
                    "shape_mismatch": [list(pt.shape), list(st.shape)],
                }
            close = bool(np.allclose(pt, st, atol=atol, rtol=rtol))
            out: Dict[str, Any] = {"kind": "predict", "diverged": not close}
            if not close:
                out["max_abs_delta"] = float(np.max(np.abs(pt - st)))
            return out
        return {"kind": "opaque", "diverged": p != s}
    except Exception as e:  # noqa: BLE001 - diffing must never break serving
        return {"kind": "opaque", "diverged": True, "error": str(e)[:200]}
