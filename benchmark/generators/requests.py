"""The general traffic generator: an open loop of requests at a fixed rate.

A traffic file (``benchmark/traffic/<name>.json``) names this module as
its ``generator`` and gives its parameters:

    kind          "generate" (prompt tokens, a budget of new tokens) or
                  "predict" (rows of token ids padded to ``pad_to``)
    rate_per_s    offered requests a second; arrivals are an open loop
    arrivals      "poisson" (exponential gaps) or "uniform" (equal gaps)
    prompt        the prompt's length (generate, unshared prompts)
    output        the budget of new tokens (generate)
    shared        documents shared by many prompts (generate):
                  {"documents", "doc_len", "zipf_s", "suffix"}
    rows, row_len, pad_to
                  rows per request, each row's real length, the padded
                  width (predict)
    temperature   0 (greedy) for every request
    id_low        the smallest token id drawn (ids run to the vocabulary)

A length is ``{"dist": "lognormal", "median", "sigma", "min", "max"}``,
``{"dist": "uniform", "min", "max"}`` or ``{"dist": "fixed", "value"}``.

Every seed gets the same multiset of lengths, documents and gaps: each is
drawn as the quantiles of its distribution at the points (j + 0.5) / n,
then put in an order drawn from the seed. Token ids are drawn from the
seed. So two seeds offer the same work in another order, and the spread
between seeds is that of the system, not of the work.

Only numpy and the standard library: the load generator's process
imports this module, and it touches neither torch nor the device.
"""

from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()


def quantiles(spec: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (j + 0.5) / n of ``spec``, as ints
    clipped to [min, max]."""
    p = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "fixed":
        return np.full(n, int(spec["value"]), dtype=np.int64)
    if dist == "uniform":
        lo, hi = int(spec["min"]), int(spec["max"])
        vals = lo + p * (hi - lo + 1)
        return np.clip(np.floor(vals), lo, hi).astype(np.int64)
    if dist == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(x)) for x in p])
        vals = np.exp(math.log(float(spec["median"])) + float(spec["sigma"]) * z)
        return np.clip(np.rint(vals), int(spec["min"]), int(spec["max"])).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist!r}")


def zipf_counts(k: int, s: float, n: int) -> np.ndarray:
    """Document indices for ``n`` requests: the quantiles of Zipf(s) over
    ``k`` documents (document 0 the most popular)."""
    w = 1.0 / np.arange(1, k + 1) ** s
    cdf = np.cumsum(w / w.sum())
    p = (np.arange(n) + 0.5) / n
    return np.searchsorted(cdf, p, side="right").clip(0, k - 1).astype(np.int64)


def arrival_offsets(params: Dict[str, Any], n: int, seconds: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Send times in [0, seconds) of ``n`` requests: the gaps' quantiles
    (exponential for "poisson"), in an order drawn from ``rng``, scaled so
    that the n gaps fill the window."""
    p = (np.arange(n) + 0.5) / n
    kind = params.get("arrivals", "poisson")
    if kind == "poisson":
        gaps = -np.log1p(-p)
    elif kind == "uniform":
        gaps = np.ones(n)
    else:
        raise ValueError(f"unknown arrivals {kind!r}")
    gaps = rng.permutation(gaps)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return t * (seconds / gaps.sum())


class Plan:
    """The requests of one run: ``len(plan)`` requests, each with its send
    time ``t[i]`` (seconds from the window's start) and its sizes; the
    token ids of request ``i`` come from :meth:`prompt` or :meth:`rows`,
    computed on demand from the seed so that two processes agree."""

    def __init__(self, params: Dict[str, Any], seed: int, seconds: float, vocab: int,
                 rate: Optional[float] = None):
        self.params = params
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.kind = params["kind"]
        self.rate = float(rate if rate is not None else params["rate_per_s"])
        self.seconds = float(seconds)
        n = max(1, int(round(self.rate * self.seconds)))
        self.n = n
        order = np.random.default_rng([self.seed, 1])
        self.t = arrival_offsets(params, n, self.seconds, order)
        self.id_low = int(params.get("id_low", 1))
        self.temperature = float(params.get("temperature", 0.0))
        self.doc = None
        if self.kind == "generate":
            self.max_new = order.permutation(quantiles(params["output"], n))
            shared = params.get("shared")
            if shared:
                self.doc = order.permutation(
                    zipf_counts(int(shared["documents"]), float(shared["zipf_s"]), n))
                self.own_len = order.permutation(quantiles(shared["suffix"], n))
                self.doc_len = int(shared["doc_len"])
                docs = np.random.default_rng([self.seed, 2])
                self.documents = docs.integers(
                    self.id_low, self.vocab, (int(shared["documents"]), self.doc_len))
            else:
                self.own_len = order.permutation(quantiles(params["prompt"], n))
                self.doc_len = 0
            self.prompt_len = self.own_len + self.doc_len
        elif self.kind == "predict":
            self.n_rows = int(params["rows"])
            self.pad_to = int(params["pad_to"])
            lens = quantiles(params["row_len"], n * self.n_rows)
            self.row_lens = order.permutation(lens).reshape(n, self.n_rows)
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")

    def __len__(self) -> int:
        return self.n

    def _rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, 3, int(i)])

    def prompt(self, i: int) -> List[int]:
        """The prompt token ids of generate request ``i``."""
        own = self._rng(i).integers(self.id_low, self.vocab, int(self.own_len[i]))
        if self.doc is not None:
            own = np.concatenate([self.documents[self.doc[i]], own])
        return [int(x) for x in own]

    def rows(self, i: int) -> np.ndarray:
        """The ``[rows, pad_to]`` int32 token ids of predict request ``i``:
        each row its real length of ids, then 0 (padding)."""
        rng = self._rng(i)
        ids = rng.integers(self.id_low, self.vocab, (self.n_rows, self.pad_to))
        mask = np.arange(self.pad_to)[None, :] < self.row_lens[i][:, None]
        return np.where(mask, ids, 0).astype(np.int32)

    def largest(self) -> Dict[str, int]:
        """The largest sizes any request of the mix can have (the shapes
        set-up has to warm), from the distributions' bounds."""
        p = self.params
        if self.kind == "predict":
            return {"rows": self.n_rows, "pad_to": self.pad_to}
        out = _bound(p["output"], "max")
        if p.get("shared"):
            lo = int(p["shared"]["doc_len"]) + _bound(p["shared"]["suffix"], "min")
            hi = int(p["shared"]["doc_len"]) + _bound(p["shared"]["suffix"], "max")
        else:
            lo, hi = _bound(p["prompt"], "min"), _bound(p["prompt"], "max")
        return {"prompt_min": lo, "prompt_max": hi, "output_max": out}


def _bound(spec: Dict[str, Any], which: str) -> int:
    return int(spec["value"] if spec["dist"] == "fixed" else spec[which])


def plan(params: Dict[str, Any], seed: int, seconds: float, vocab: int,
         rate: Optional[float] = None) -> Plan:
    return Plan(params, seed, seconds, vocab, rate=rate)
