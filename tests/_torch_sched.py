"""Shared set-up of the scheduler-feature tests of the port
(tests/test_torch_{fused,depth_groups,chunked}.py): the tiny config of
tests/test_torch_serving.py, the JAX and the port model on the same
weights, and a JAX reference that runs each request ALONE on a JAX
batcher built with the knobs under test (see ROADMAP.md queue C: under
concurrent submits on the CPU the JAX batcher has been seen to emit an
idle lane's filler token)."""

import jax
import numpy as np
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

torch.set_num_threads(1)

CFG = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=64, dtype="float32")
BASE = dict(slots=4, max_seq=64, prefill_buckets=(8, 16, 32), steps_per_poll=2)

# staggered budgets: fused K must shrink, lanes finish at different steps
PROMPTS = [[3, 17, 42, 99, 7], [1, 2, 3], [9, 8, 7, 6], [5, 5, 5, 5, 5, 5]]
BUDGETS = [20, 7, 13, 9]


def make_models():
    jm, tm = JaxLM(**CFG), TorchLM(**CFG)
    jp = jax.jit(jm.init_params)(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


class JaxReference:
    """``ref(requests, **knobs)``: the JAX batcher's output for each
    ``(prompt, submit kwargs)``, every request run alone, memoised."""

    def __init__(self, models):
        self._jm, self._jp = models[0], models[1]
        self._batchers = {}
        self._memo = {}

    def __call__(self, requests, **knobs):
        kkey = tuple(sorted(knobs.items()))
        if kkey not in self._batchers:
            self._batchers[kkey] = JaxBatcher(self._jm, self._jp, **{**BASE, **knobs})
        b = self._batchers[kkey]
        out = []
        for p, kw in requests:
            key = (kkey, tuple(p), tuple(sorted(kw.items())))
            if key not in self._memo:
                self._memo[key] = b.submit(p, **kw).result(timeout=300)
            out.append(self._memo[key])
        return out

    def close(self):
        for b in self._batchers.values():
            b.close()


def port(models, **kw):
    return ContinuousBatcher(models[2], models[3], **{**BASE, **kw})


def run_port(models, requests, stagger=0.0, **kw):
    """Submit every request to one port batcher (concurrently, or
    staggered by ``stagger`` seconds every other submit) and return
    ``(outputs, stats)``."""
    import time

    b = port(models, **kw)
    try:
        futs = []
        for i, (p, rkw) in enumerate(requests):
            futs.append(b.submit(p, **rkw))
            if stagger and i % 2:
                time.sleep(stagger)
        got = [f.result(timeout=120) for f in futs]
        return got, dict(b.stats)
    finally:
        b.close()


def batch(temperature=0.0):
    """PROMPTS with BUDGETS, each with its own seed."""
    return [
        (p, dict(max_new_tokens=m, temperature=temperature, seed=11 + i))
        for i, (p, m) in enumerate(zip(PROMPTS, BUDGETS))
    ]


def mixed(seed, lengths, max_new=8, temperature=0.0):
    """Prompts of the given lengths from a numpy seed; odd ones sampled
    when ``temperature`` is set."""
    rs = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(lengths):
        kw = dict(max_new_tokens=max_new + i % 3)
        if temperature and i % 2:
            kw.update(temperature=temperature, seed=i)
        out.append((rs.randint(0, CFG["vocab_size"], n).tolist(), kw))
    return out
