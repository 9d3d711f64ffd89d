"""The port's anchors (seldon_core_tpu_torch.components.anchors) against
the JAX package's, on the CPU: the same seed and the same ``predict_fn``
give the same rule, precision, coverage and prediction (every key of
the explanation equal), and the JAX tests' properties hold."""

import numpy as np
import pytest

from seldon_core_tpu.components import anchors as jax_anchors
from seldon_core_tpu_torch.components import anchors


def _one_feature(z):
    return (np.asarray(z)[:, 0] > 0).astype(np.int64)


def _and_of_two(z):
    z = np.asarray(z)
    return ((z[:, 0] > 0) & (z[:, 2] > 0)).astype(np.int64)


def _probs(z):
    z = np.asarray(z)
    logit = 2.0 * z[:, 1] - z[:, 3]
    p = 1.0 / (1.0 + np.exp(-logit))
    return np.stack([1 - p, p], axis=1)


TABULAR = {
    # name: (predict_fn, train shape, instance, seed, kwargs)
    "one-feature": (_one_feature, (800, 3), [0.9, 0.1, -0.5], 1,
                    {"feature_names": ["a", "b", "c"]}),
    "and-of-two": (_and_of_two, (1000, 4), [0.9, 0.0, 0.9, 0.0], 2, {}),
    "probabilities": (_probs, (600, 4), [0.1, 0.8, -0.3, -0.7], 5, {"n_bins": 3}),
    "not-converged": (_probs, (300, 4), [0.0, 0.05, 0.0, 0.1], 4,
                      {"max_anchor_size": 1, "precision_threshold": 0.99}),
}


@pytest.mark.parametrize("case", sorted(TABULAR))
def test_tabular_equals_jax(case):
    fn, shape, x, seed, kw = TABULAR[case]
    train = np.random.RandomState(0).uniform(-1, 1, size=shape)
    outs = [pkg.AnchorTabular(fn, train, seed=seed, **kw).explain(np.array(x))
            for pkg in (jax_anchors, anchors)]
    assert dict(outs[1]) == dict(outs[0])
    assert outs[1].anchor == outs[0].anchor
    assert outs[1].precision == outs[0].precision and outs[1].coverage == outs[0].coverage


def test_tabular_properties_as_jax():
    """The JAX tests' properties on the port: the deciding feature
    pinned, the AND of two grown to two predicates."""
    fn, shape, x, seed, kw = TABULAR["one-feature"]
    train = np.random.RandomState(0).uniform(-1, 1, size=shape)
    out = anchors.AnchorTabular(fn, train, seed=seed, **kw).explain(np.array(x))
    assert out["anchor_features"] == ["a"] and out["prediction"] == 1
    assert out["converged"] is True and out["precision"] >= 0.95
    assert 0.1 < out["coverage"] < 0.45 and "a >" in out["anchor"][0]
    fn, shape, x, seed, kw = TABULAR["and-of-two"]
    train = np.random.RandomState(0).uniform(-1, 1, size=shape)
    out = anchors.AnchorTabular(fn, train, seed=seed).explain(np.array(x))
    assert set(out["anchor_features"]) == {"f0", "f2"} and out["converged"]


@pytest.mark.parametrize("text", ["this movie is good fun", "good", "not good not bad at all"])
def test_text_equals_jax(text):
    def predict(texts):
        return np.asarray([1 if "good" in t.split() else 0 for t in texts])

    outs = [pkg.AnchorText(predict, seed=3).explain(text) for pkg in (jax_anchors, anchors)]
    assert dict(outs[1]) == dict(outs[0])
    assert outs[1]["anchor"] == ["good"] and outs[1]["prediction"] == 1


@pytest.mark.parametrize("pkg", [jax_anchors, anchors], ids=["jax", "port"])
def test_bad_inputs_raise_as_jax(pkg):
    exp = pkg.AnchorTabular(lambda z: np.zeros(len(z)), np.zeros((10, 3)))
    with pytest.raises(ValueError, match="features"):
        exp.explain(np.zeros(5))
    with pytest.raises(ValueError, match="empty text"):
        pkg.AnchorText(lambda t: np.zeros(len(t))).explain("   ")


def test_labels_of_as_jax():
    for preds in (np.array([[0.2, 0.8], [0.9, 0.1]]), np.array([0.4, 1.6, 2.0]),
                  np.array([[1.0], [0.0]])):
        np.testing.assert_array_equal(anchors._labels_of(preds), jax_anchors._labels_of(preds))
