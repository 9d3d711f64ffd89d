"""The bandit routers of seldon_core_tpu_torch (components/routers.py)
against the JAX package's, on the CPU.

Both are numpy: for the same seed and the same feedback sequence the
port must route exactly as the JAX router does, branch for branch, and
end in the same state. The state dict survives the port's
``persistence.py`` (``.npz``) and an engine rebuild, and the JAX
package's feedback-loop case (tests/test_routers.py) runs on the port's
GraphExecutor.
"""

import asyncio

import numpy as np
import pytest

from seldon_core_tpu.components import routers as jax_routers
from seldon_core_tpu_torch import persistence
from seldon_core_tpu_torch.components import BanditState, EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.graph.executor import GraphExecutor
from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor
from seldon_core_tpu_torch.user_model import SeldonComponent

CASES = [
    ("EpsilonGreedy", dict(n_branches=2, epsilon=0.1, seed=7)),
    ("EpsilonGreedy", dict(n_branches=3, epsilon=0.5, seed=1, best_branch=2)),
    ("EpsilonGreedy", dict(n_branches=4, epsilon=1.0, seed=11, history=True)),
    ("ThompsonSampling", dict(n_branches=2, seed=7)),
    ("ThompsonSampling", dict(n_branches=5, seed=3, history=True)),
]
PORT = {"EpsilonGreedy": EpsilonGreedy, "ThompsonSampling": ThompsonSampling}


def _drive(router, n, p_good, rows=4):
    """Route ``n`` requests of ``rows`` rows; each routed arm's reward is a
    Bernoulli batch mean from numpy seed 1 (arm i succeeds with
    p_good[i])."""
    rng = np.random.RandomState(1)
    X = np.zeros((rows, 2))
    branches = []
    for _ in range(n):
        b = router.route(X, [])
        branches.append(b)
        reward = rng.binomial(rows, p_good[b]) / rows
        router.send_feedback(X, [], reward, None, routing=b)
    return branches


@pytest.mark.parametrize("name,kw", CASES)
def test_routes_identical_to_jax(name, kw):
    p_good = np.linspace(0.1, 0.9, kw["n_branches"])
    mine, ref = PORT[name](**kw), getattr(jax_routers, name)(**kw)
    assert _drive(mine, 300, p_good) == _drive(ref, 300, p_good)
    np.testing.assert_array_equal(mine.state.success, ref.state.success)
    np.testing.assert_array_equal(mine.state.tries, ref.state.tries)
    assert mine.state.best_branch == ref.state.best_branch
    assert mine.tags() == ref.tags() and mine.metrics() == ref.metrics()
    assert mine.branch_history == ref.branch_history
    for a, b in zip(mine.value_history, ref.value_history):
        np.testing.assert_array_equal(a, b)


def test_feedback_without_routing_is_ignored_and_bad_branches_refused():
    r = EpsilonGreedy(n_branches=2, seed=0)
    r.send_feedback(np.zeros((3, 1)), [], 1.0, None, routing=None)
    assert r.state.tries.sum() == 0
    with pytest.raises(ValueError, match="positive"):
        ThompsonSampling(n_branches=0)
    assert EpsilonGreedy(n_branches=2, best_branch=1, branch_names="a:b").tags() == \
        {"best_branch": "b"}


@pytest.mark.parametrize("name", ["EpsilonGreedy", "ThompsonSampling"])
def test_state_survives_persistence(tmp_path, name):
    router = PORT[name](n_branches=3, seed=5)
    _drive(router, 50, [0.2, 0.5, 0.8])
    key = persistence.state_key("router", "pred", "dep")
    path = persistence.persist(router, str(tmp_path), key)
    assert path.endswith(".npz")
    back = persistence.restore(PORT[name], {"n_branches": 3, "seed": 5}, str(tmp_path), key)
    np.testing.assert_array_equal(back.state.success, router.state.success)
    np.testing.assert_array_equal(back.state.tries, router.state.tries)
    assert back.state.best_branch == router.state.best_branch
    assert isinstance(back.state, BanditState) and back.state.tries.dtype == np.float64


class _FixedModel(SeldonComponent):
    """Stub model whose 'accuracy' drives the bandit's reward."""

    def __init__(self, accuracy: float):
        self.accuracy = accuracy

    def predict(self, X, names, meta=None):
        return np.full((np.asarray(X).shape[0], 1), self.accuracy)


def _graph_executor(router):
    graph = {"name": "router", "type": "ROUTER",
             "children": [{"name": "bad", "type": "MODEL"}, {"name": "good", "type": "MODEL"}]}
    spec = default_predictor(PredictorSpec.from_dict({"name": "p", "graph": graph}))
    return GraphExecutor(spec, registry={
        "router": router, "bad": _FixedModel(0.1), "good": _FixedModel(0.9)})


def test_mab_feedback_loop_through_graph(tmp_path):
    """The JAX package's case study on the port's engine: route via
    Thompson sampling over two models, replay rewards through the
    engine's feedback path, converge to the better model; then persist
    the router, rebuild the engine around the restored router, and find
    the same state."""
    router = ThompsonSampling(n_branches=2, seed=7)
    ex = _graph_executor(router)
    rng = np.random.default_rng(1)

    async def loop():
        req = {"data": {"ndarray": [[1.0, 2.0]] * 4}}
        for _ in range(200):
            resp = await ex.predict(dict(req))
            acc = resp["data"]["ndarray"][0][0]
            reward = rng.binomial(4, acc) / 4.0
            await ex.send_feedback({"request": req, "response": resp, "reward": reward})

    asyncio.run(loop())
    assert router.state.best_branch == 1
    assert router.state.tries.sum() == 200 * 4
    # the better arm should have drawn most of the traffic
    assert router.state.tries[1] > router.state.tries[0]

    key = persistence.state_key("router")
    persistence.persist(router, str(tmp_path), key)
    restored = persistence.restore(ThompsonSampling, {"n_branches": 2, "seed": 7},
                                   str(tmp_path), key)
    ex2 = _graph_executor(restored)
    assert ex2.root.client.user_object is restored
    np.testing.assert_array_equal(restored.state.success, router.state.success)
    np.testing.assert_array_equal(restored.state.tries, router.state.tries)
    assert restored.state.best_branch == router.state.best_branch
    resp = asyncio.run(ex2.predict({"data": {"ndarray": [[1.0, 2.0]]}}))
    assert resp["meta"]["routing"]["router"] in (0, 1)
