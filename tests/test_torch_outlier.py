"""The outlier and drift detectors of seldon_core_tpu_torch against the JAX
package's, on the CPU.

Each detector gets the same numpy-seeded data under both packages. The
device-backed ones (VAE, seq2seq) score the JAX package's trained
parameters handed over through ``fit_from``: scores within 1e-5
relative (float32 matmuls in another summation order; the VAE's latent
noise also carries ``rng.normal``'s few-ulp difference from
``jax.random.normal``) and equal flags. The port's seeded ``*_init``
gives the JAX package's parameters within ``rng.normal``'s tolerance.
Mahalanobis, the isolation forest and KS drift are numpy/sklearn under
both packages: equal scores, flags and verdicts. State dicts go through
``persistence.py`` as ``.npz``.

Training (``train_vae``, ``train_seq2seq``, ``fit``) from one seed under
both packages: every parameter within ``TRAIN_TOL`` (1e-5) of its
leaf's largest |value| after one step and after one epoch (the port
measures 1e-7 to 5e-6: float32 gradients in another summation order and
an init within rng.normal's ulps; where a gradient is near Adam's eps
(1e-8), ``m/(sqrt(v) + eps)`` turns its rounding into a share of
``lr``). The full
default run (50 epochs) is held by the detector's flags, equal, and
scores within ``TRAINED_SCORE_RTOL`` (1e-3 relative).
"""

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.components import drift as jdrift
from seldon_core_tpu.components import outlier as jout
from seldon_core_tpu_torch import persistence, rng
from seldon_core_tpu_torch.components import drift as tdrift
from seldon_core_tpu_torch.components import outlier as tout

torch.set_num_threads(1)

SCORE_RTOL = 1e-5
TRAIN_TOL = 1e-5
TRAINED_SCORE_RTOL = 1e-3
# rng.normal against jax.random.normal, in float32 ulps (see
# tests/test_torch_retrieval.py); a scaled draw may add one rounding
INIT_ULPS = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(seed=0, n=200, f=3):
    rs = np.random.default_rng(seed)
    inliers = rs.normal(0, 1, (n, f))
    batches = [rs.normal(0, 1, (8, f)), rs.normal(6, 1, (4, f)),
               np.concatenate([rs.normal(0, 1, (3, f)), rs.normal(9, 1, (2, f))])]
    return inliers, batches


def _flags_and_scores(det, batches):
    out = []
    for b in batches:
        flags = det.predict(b, [])
        out.append((np.asarray(flags), np.asarray(det.score_)))
    return out


def _assert_same(jres, tres, rtol=0.0):
    for (jf, js), (tf, ts) in zip(jres, tres):
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(ts, js, rtol=rtol, atol=0.0)


@pytest.fixture(scope="module")
def vae_trained():
    X, _ = _data()
    return jout.vae.train_vae(X, hidden=(8,), latent_dim=2, epochs=3, batch_size=64, seed=0)


@pytest.fixture(scope="module")
def seq_trained():
    rs = np.random.default_rng(1)
    X = np.sin(np.linspace(0, 6, 10))[None, :, None] + rs.normal(0, 0.1, (40, 10, 2))
    return jout.seq2seq.train_seq2seq(X, hidden=6, epochs=3, batch_size=16, seed=0), X


def test_vae_scores_equal_jax_fit_from(vae_trained):
    params, stats = vae_trained
    _, batches = _data()
    jd = jout.VAEOutlier(threshold=3.0, mc_samples=4, seed=2).fit_from(params, stats)
    td = tout.VAEOutlier(threshold=3.0, mc_samples=4, seed=2, device="cpu").fit_from(
        _np(params), stats)
    jres, tres = _flags_and_scores(jd, batches), _flags_and_scores(td, batches)
    _assert_same(jres, tres, SCORE_RTOL)
    assert sum(int(f.sum()) for f, _ in tres) > 0  # the shifted rows flag
    assert td.tags() == jd.tags() and len(td.metrics()) == len(jd.metrics())


def test_seq2seq_scores_equal_jax_fit_from(seq_trained):
    (params, stats), X = seq_trained
    rs = np.random.default_rng(3)
    batches = [X[:5], X[5:8] + rs.normal(3, 1, (3, 10, 2)), X[8:12].reshape(4, 20)]
    jd = jout.Seq2SeqOutlier(threshold=0.5, seq_len=10).fit_from(params, stats)
    td = tout.Seq2SeqOutlier(threshold=0.5, seq_len=10, device="cpu").fit_from(
        _np(params), stats)
    jres, tres = _flags_and_scores(jd, batches), _flags_and_scores(td, batches)
    _assert_same(jres, tres, SCORE_RTOL)
    assert int(tres[1][0].sum()) > 0


def test_seeded_init_equals_jax():
    """vae_init and seq2seq_init draw the JAX package's parameters from the
    same key, within rng.normal's ulps (shapes, zero biases and key chain
    exact)."""
    for jp, tp in (
        (jout.vae.vae_init(jax.random.PRNGKey(5), 4, (8, 6), 2),
         tout.vae.vae_init(rng.prng_key(5), 4, (8, 6), 2)),
        (jout.seq2seq.seq2seq_init(jax.random.PRNGKey(5), 3, 7),
         tout.seq2seq.seq2seq_init(rng.prng_key(5), 3, 7)),
    ):
        jl = jax.tree_util.tree_leaves_with_path(_np(jp))
        tl = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), tp))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert a.shape == b.shape and b.dtype == np.float32
            np.testing.assert_allclose(
                b, a, rtol=0, atol=INIT_ULPS * np.spacing(np.abs(a).max()))


def test_vae_and_seq2seq_apply_equal_jax_on_seeded_params():
    """The port's forwards on its own seeded parameters against the JAX
    forwards on the JAX package's (one latent key for the VAE)."""
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    jp = jout.vae.vae_init(jax.random.PRNGKey(1), 4, (8,), 2)
    tp = tout.vae.vae_init(rng.prng_key(1), 4, (8,), 2)
    jr = np.asarray(jout.vae.vae_apply(jp, x, jax.random.PRNGKey(9))[0])
    tr = tout.vae.vae_apply(tp, torch.from_numpy(x), rng.prng_key(9))[0].numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5 * np.abs(jr).max())
    xs = np.random.RandomState(1).randn(3, 6, 2).astype(np.float32)
    jp = jout.seq2seq.seq2seq_init(jax.random.PRNGKey(1), 2, 5)
    tp = tout.seq2seq.seq2seq_init(rng.prng_key(1), 2, 5)
    jr = np.asarray(jout.seq2seq.seq2seq_apply(jp, xs))
    tr = tout.seq2seq.seq2seq_apply(tp, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5 * np.abs(jr).max())


def test_mahalanobis_streaming_equals_jax():
    X, batches = _data(seed=4)
    kw = dict(threshold=9.0, n_components=2, start_clip=20, max_n=150)
    jd, td = jout.Mahalanobis(**kw), tout.Mahalanobis(**kw)
    stream = [X[i:i + 25] for i in range(0, 200, 25)] + batches
    _assert_same(_flags_and_scores(jd, stream), _flags_and_scores(td, stream))
    assert td.tags() == jd.tags() and td.metrics() == jd.metrics()


def test_iforest_equals_jax():
    pytest.importorskip("sklearn")
    X, batches = _data(seed=5)
    jd = jout.IsolationForestOutlier(threshold=0.0, n_estimators=20, seed=3).fit(X)
    td = tout.IsolationForestOutlier(threshold=0.0, n_estimators=20, seed=3).fit(X)
    _assert_same(_flags_and_scores(jd, batches), _flags_and_scores(td, batches))


def test_iforest_unfitted_and_without_sklearn(monkeypatch):
    """Unfitted scoring raises as the JAX detector does; without sklearn,
    fit raises the same ModuleNotFoundError under both packages."""
    import sys

    det = tout.IsolationForestOutlier()
    with pytest.raises(RuntimeError, match="not fitted"):
        det.score(np.zeros((1, 3)))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    errors = []
    for pkg in (jout, tout):
        with pytest.raises(ImportError) as e:
            pkg.IsolationForestOutlier().fit(np.zeros((4, 3)))
        errors.append(type(e.value))
    assert errors[0] is errors[1]


@pytest.mark.parametrize("shift", [0.0, 1.5])
def test_ks_drift_verdicts_equal_jax(shift):
    rs = np.random.RandomState(7)
    ref = rs.randn(300, 3)
    windows = [rs.randn(16, 3) + shift for _ in range(6)]
    dets = [m.KSDrift(reference=ref, window=64, min_window=32) for m in (jdrift, tdrift)]
    for w in windows:
        outs = [d.predict(w, []) for d in dets]
        np.testing.assert_array_equal(outs[0], outs[1])
        assert dets[0].tags() == dets[1].tags() and dets[0].metrics() == dets[1].metrics()
    assert dets[1].drifted is (shift > 0)


def test_state_dicts_persist_as_npz(tmp_path, vae_trained, seq_trained):
    """The port's counterpart of the JAX package's VAE state-dict
    persistence case: VAE, seq2seq, Mahalanobis and KS drift through
    ``persistence.persist``/``restore`` as ``.npz``; the restored detector
    scores as the original."""
    params, stats = vae_trained
    _, batches = _data()
    vae = tout.VAEOutlier(threshold=5.0, mc_samples=2, seed=0, device="cpu").fit_from(
        _np(params), stats)
    path = persistence.persist(vae, str(tmp_path), "vae")
    assert path.endswith(".npz")
    vae2 = persistence.restore(
        tout.VAEOutlier, {"threshold": 5.0, "mc_samples": 2, "seed": 0, "device": "cpu"},
        str(tmp_path), "vae")
    assert isinstance(vae2.params["enc"], list)
    np.testing.assert_array_equal(vae.score(batches[2]), vae2.score(batches[2]))

    (sparams, sstats), X = seq_trained
    seq = tout.Seq2SeqOutlier(threshold=0.5, device="cpu").fit_from(_np(sparams), sstats)
    persistence.persist(seq, str(tmp_path), "seq")
    seq2 = persistence.restore(tout.Seq2SeqOutlier, {"device": "cpu"}, str(tmp_path), "seq")
    np.testing.assert_array_equal(seq.score(X[:3]), seq2.score(X[:3]))

    maha = tout.Mahalanobis()
    persistence.persist(maha, str(tmp_path), "maha-empty")  # no estimate yet
    assert persistence.restore(tout.Mahalanobis, {}, str(tmp_path), "maha-empty").mean is None
    maha.predict(batches[0], [])
    maha.predict(batches[1], [])
    persistence.persist(maha, str(tmp_path), "maha")
    maha2 = persistence.restore(tout.Mahalanobis, {}, str(tmp_path), "maha")
    np.testing.assert_array_equal(maha.score(batches[2]), maha2.score(batches[2]))

    ks = tdrift.KSDrift(reference=np.random.RandomState(0).randn(50, 3), min_window=4)
    ks.predict(np.ones((6, 3)) * 3, [])
    persistence.persist(ks, str(tmp_path), "ks")
    ks2 = persistence.restore(tdrift.KSDrift, {"min_window": 4}, str(tmp_path), "ks")
    assert ks2.drifted is True and ks2.tags() == ks.tags()


def test_vae_pickle_loads_across_packages(tmp_path, vae_trained):
    """``vae.pkl`` written by the JAX detector loads in the port's (the
    layout is the same numpy tree) and scores the same."""
    params, stats = vae_trained
    jd = jout.VAEOutlier(mc_samples=3, seed=1).fit_from(params, stats)
    jd.save(str(tmp_path))
    td = tout.VAEOutlier(mc_samples=3, seed=1, model_uri=str(tmp_path), device="cpu")
    td.load()
    x = _data()[1][1]
    np.testing.assert_allclose(td.score(x), jd.score(x), rtol=SCORE_RTOL)


def test_training_not_ported():
    """Training is ported now (the name is the former case's): ``fit``
    trains the device detectors on the CPU, and scoring before any fit
    still raises "not fitted"."""
    X = np.random.default_rng(0).normal(0, 1, (40, 3))
    vae = tout.VAEOutlier(device="cpu").fit(X, epochs=1)
    assert np.isfinite(vae.score(X[:4])).all()
    seq = tout.Seq2SeqOutlier(device="cpu").fit(X.reshape(10, 4, 3), epochs=1)
    assert np.isfinite(seq.score(X.reshape(10, 4, 3))).all()
    for cls in (tout.VAEOutlier, tout.Seq2SeqOutlier):
        with pytest.raises(RuntimeError, match="not fitted"):
            cls(device="cpu").score(np.zeros((1, 3)))


def _leaf_errors(jp, tp):
    """Each leaf's max |port - JAX| over its largest |JAX value|."""
    jl = jax.tree_util.tree_leaves_with_path(_np(jp))
    tl = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), tp))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    return [float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))
            for (_, a), (_, b) in zip(jl, tl)]


def _seqs(seed=1, n=40):
    rs = np.random.default_rng(seed)
    return np.sin(np.linspace(0, 6, 10))[None, :, None] + rs.normal(0, 0.1, (n, 10, 2))


@pytest.mark.parametrize("batch", [1000, 64], ids=["step", "epoch"])
def test_train_vae_equals_jax(batch):
    X, _ = _data(seed=6)
    kw = dict(hidden=(8,), latent_dim=2, epochs=1, batch_size=batch, seed=3)
    (jp, jstats), (tp, tstats) = jout.vae.train_vae(X, **kw), tout.train_vae(X, device="cpu", **kw)
    assert max(_leaf_errors(jp, tp)) <= TRAIN_TOL
    np.testing.assert_array_equal(tstats["mean"], jstats["mean"])
    np.testing.assert_array_equal(tstats["std"], jstats["std"])


@pytest.mark.parametrize("batch", [1000, 16], ids=["step", "epoch"])
def test_train_seq2seq_equals_jax(batch):
    X = _seqs()
    kw = dict(hidden=6, epochs=1, batch_size=batch, seed=2)
    (jp, _), (tp, _) = jout.seq2seq.train_seq2seq(X, **kw), tout.train_seq2seq(X, device="cpu", **kw)
    assert max(_leaf_errors(jp, tp)) <= TRAIN_TOL


def test_adam_step_is_optax():
    """One Adam update on the same parameters and gradients: optax's
    numbers to the float32 ulp."""
    import optax

    from seldon_core_tpu_torch.components.outlier.base import Adam

    rs = np.random.RandomState(0)
    p0 = rs.randn(5, 3).astype(np.float32)
    grads = [rs.randn(5, 3).astype(np.float32) * s for s in (1.0, 1e-3, 1e-7)]
    opt = optax.adam(1e-2)
    jp, state = jax.numpy.asarray(p0), opt.init(jax.numpy.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    tadam = Adam([tp], 1e-2)
    for g in grads:
        upd, state = opt.update(jax.numpy.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tadam.step([torch.from_numpy(g)])
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=2 * np.spacing(np.abs(np.asarray(jp)).max()))


def test_default_training_flags_equal_jax():
    """The full default runs (VAE hidden (32, 16), latent 2, 50 epochs;
    seq2seq hidden 16, 50 epochs) through ``fit``: the same flags on
    inliers and planted outliers, scores within TRAINED_SCORE_RTOL."""
    X, batches = _data(seed=8)
    jd = jout.VAEOutlier(threshold=2.0, mc_samples=4, seed=5).fit(X)
    td = tout.VAEOutlier(threshold=2.0, mc_samples=4, seed=5, device="cpu").fit(X)
    _assert_same(_flags_and_scores(jd, batches), _flags_and_scores(td, batches),
                 TRAINED_SCORE_RTOL)
    assert int(td.predict(batches[1], []).sum()) == 4  # the shifted rows flag
    S = _seqs(seed=9, n=48)
    rs = np.random.default_rng(4)
    seq_batches = [S[:6], S[6:9] + rs.normal(3, 1, (3, 10, 2)), S[9:13]]
    js = jout.Seq2SeqOutlier(threshold=0.5).fit(S)
    ts = tout.Seq2SeqOutlier(threshold=0.5, device="cpu").fit(S)
    _assert_same(_flags_and_scores(js, seq_batches), _flags_and_scores(ts, seq_batches),
                 TRAINED_SCORE_RTOL)
    assert int(ts.predict(seq_batches[1], []).sum()) == 3


def test_device_detectors_default_to_cuda():
    """Entry points default to CUDA and raise without it; the CPU is asked
    for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (tout.VAEOutlier, tout.Seq2SeqOutlier):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
