"""The port's training forward and parallel train step against the JAX
package, on the CPU at float32.

* ``DecoderLM.loss_fn`` on one device: value and every leaf's gradient
  against ``jax.value_and_grad(DecoderLM.loss_fn)`` on the same weights,
  dense and MoE (1e-6 on the loss, 1e-6 of each leaf's largest gradient).
* ``make_train_step`` on 8 gloo ranks for each mesh of
  ``tests/test_train_parallel.py`` (``dp-pp-tp``, ``pp-sp-tp``,
  ``dp-sp-tp``), 3 SGD steps from the JAX ``init_params(0)`` carried
  across: losses and final parameters against JAX ``make_train_step`` on
  the same mesh (``SAME_MESH_TOL``: float32 sums in another order), and
  against single-device SGD within the JAX test's own 2e-3 (losses) and
  5e-3 (params); one step's gradients leaf by leaf against JAX's
  single-device gradients of the global mean loss.
* The MoE EP mesh (``{data 2, stage 2, seq 1, model 2}``, 2 experts:
  one per (data, seq) rank) against the JAX EP step on the same mesh, 5
  steps, its loss falling. Capacity is per rank under EP, so it is held
  against the JAX EP step and never against one device.
* ``dryrun_multichip(8)`` on CPU ranks.

The 8-rank runs go out once per module (``tests/_torch_ranks.py``: no JAX
in the children); the JAX references run in this process on its 8
virtual CPU devices, one module-scoped fixture per mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.parallel import make_mesh as jax_make_mesh
from seldon_core_tpu.parallel.train import make_train_step as jax_make_train_step
from seldon_core_tpu.parallel.train import unstack_stages as jax_unstack
from seldon_core_tpu_torch.convert import params_from_numpy, sorted_leaves
from seldon_core_tpu_torch.models.llm import DecoderLM
from seldon_core_tpu_torch.parallel.launch import launch
from seldon_core_tpu_torch.parallel.train import (
    dryrun_factorizations, dryrun_multichip, grad_sum_axes, param_specs)

import _torch_ranks

LOSS_FN_TOL = 1e-6
SAME_MESH_TOL = 1e-5  # losses and params, port vs JAX on one mesh
SGD_LOSS_TOL, SGD_PARAM_TOL = 2e-3, 5e-3  # tests/test_train_parallel.py's
GRAD_TOL = 1e-5  # of each leaf's largest single-device gradient
LR, STEPS, MOE_STEPS = 0.05, 3, 5

CFG = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=64,
           max_seq=32, dtype="float32")
MOE_CFG = dict(CFG, n_experts=2)
MESHES = {
    "dp-pp-tp": {"data": 2, "stage": 2, "seq": 1, "model": 2},
    "pp-sp-tp": {"data": 1, "stage": 2, "seq": 2, "model": 2},
    "dp-sp-tp": {"data": 2, "stage": 1, "seq": 2, "model": 2},
}
MOE_MESH = {"data": 2, "stage": 2, "seq": 1, "model": 2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens():
    return np.random.RandomState(0).randint(0, 64, (8, 17)).astype(np.int32)


def _ce_mean(model, params, toks):
    logits = model.apply(params, toks[:, :-1])
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, toks[:, 1:][..., None], axis=-1)[..., 0].mean()


@pytest.fixture(scope="module")
def host():
    """The JAX ``init_params(0)`` of both models, as numpy."""
    return {"dense": _np_tree(JaxLM(**CFG).init_params(0)),
            "moe": _np_tree(JaxLM(**MOE_CFG).init_params(0))}


def _jax_mesh_run(cfg, mesh_shape, steps):
    model = JaxLM(**cfg)
    init, step = jax_make_train_step(model, jax_make_mesh(mesh_shape), n_microbatches=2,
                                     learning_rate=LR)
    params = init(0)
    toks = jnp.asarray(_tokens())
    losses = []
    for _ in range(steps):
        params, loss = step(params, toks)
        losses.append(float(loss))
    return losses, _np_tree(jax_unstack(jax.device_get(params)))


@pytest.fixture(scope="module")
def single_device(host):
    """JAX single-device SGD (the JAX test's ``single_chip_sgd``) and the
    first step's gradients of the global mean loss."""
    model = JaxLM(**CFG)
    toks = jnp.asarray(_tokens())
    vg = jax.jit(jax.value_and_grad(lambda p: _ce_mean(model, p, toks)))
    params = jax.tree_util.tree_map(jnp.asarray, host["dense"])
    losses, grads0 = [], None
    for _ in range(STEPS):
        loss, g = vg(params)
        grads0 = _np_tree(g) if grads0 is None else grads0
        params = jax.tree_util.tree_map(lambda a, b: (a - LR * b).astype(a.dtype), params, g)
        losses.append(float(loss))
    return {"losses": losses, "final": _np_tree(params), "grads": grads0}


@pytest.fixture(scope="module", params=list(MESHES))
def jax_mesh_ref(request):
    """JAX ``make_train_step`` on one mesh: 3 losses and final params."""
    losses, final = _jax_mesh_run(CFG, MESHES[request.param], STEPS)
    return request.param, losses, final


@pytest.fixture(scope="module")
def jax_moe_ref():
    return _jax_mesh_run(MOE_CFG, MOE_MESH, MOE_STEPS)


@pytest.fixture(scope="module")
def port_runs(host):
    """Every mesh's run of the port on one launch of 8 gloo ranks."""
    toks = _tokens()
    jobs = [dict(name=name, mesh=shape, cfg=CFG, params=host["dense"], tokens=toks, lr=LR,
                 steps=STEPS) for name, shape in MESHES.items()]
    jobs.append(dict(name="moe", mesh=MOE_MESH, cfg=MOE_CFG, params=host["moe"], tokens=toks,
                     lr=LR, steps=MOE_STEPS))
    ranks = launch(_torch_ranks.train_runs, 8, args=(jobs,), backend="gloo", timeout_s=600)
    for name in [j["name"] for j in jobs]:  # every rank reports the same losses
        assert all(r[name]["losses"] == ranks[0][name]["losses"] for r in ranks), name
    return ranks[0]


def _assert_trees(got, want, atol, what):
    for (path, a), (_p, b) in zip(sorted_leaves(got), sorted_leaves(want)):
        assert a.shape == b.shape, (what, path)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {path}")


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_loss_fn_value_and_grads_equal_jax(moe):
    cfg = dict(CFG, n_layers=2, n_kv_heads=2, **({"n_experts": 4} if moe else {}))
    jm, tm = JaxLM(**cfg), DecoderLM(**cfg)
    jp = jm.init_params(0)
    toks = np.random.RandomState(1).randint(0, 64, (4, 17)).astype(np.int32)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jnp.asarray(toks))
    params = params_from_numpy(_np_tree(jp), device="cpu")
    leaves = [p.requires_grad_(True) for _, p in sorted_leaves(params)]
    loss = tm.loss_fn(params, torch.as_tensor(toks))
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - float(jl)) <= LOSS_FN_TOL
    for (path, want), got in zip(sorted_leaves(_np_tree(jg)), grads):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, atol=LOSS_FN_TOL * scale, rtol=0,
                                   err_msg=str(path))


def test_loss_fn_leaves_apply_on_the_kernel_path():
    """``apply`` still runs under inference_mode (the flash kernel's
    path); ``loss_fn`` is differentiable and its value is the mean
    next-token cross-entropy of ``apply``'s logits."""
    model = DecoderLM(**dict(CFG, n_layers=2))
    params = model.init_params(0, device="cpu")
    toks = torch.as_tensor(_tokens()[:2])
    logits = model.apply(params, toks[:, :-1])
    assert logits.is_inference()
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, 64), toks[:, 1:].reshape(-1).long())
    loss = model.loss_fn(params, toks)
    assert not loss.is_inference()
    np.testing.assert_allclose(float(loss), float(ce), rtol=1e-6)


def test_grad_sum_rule_covers_every_leaf():
    """Each leaf's gradient sum is written down next to its spec: every
    axis a leaf is not sharded over among data/seq is summed (experts
    excepted), stage only outside the blocks, model never."""
    for cfg in (CFG, MOE_CFG):
        specs = param_specs(DecoderLM(**cfg), 2)
        for path, spec in _spec_leaves(specs):
            axes = grad_sum_axes(path)
            sharded = {a for entry in spec if entry for a in
                       (entry if isinstance(entry, tuple) else (entry,))}
            assert "model" not in axes
            assert not sharded & set(axes), (path, spec, axes)
            assert ("stage" in axes) == (path[0] != "blocks")
            assert {"data", "seq"} <= set(axes) | sharded


def _spec_leaves(specs):
    out = [((k,), v) for k, v in specs.items() if k != "blocks"]
    return out + [(("blocks", k), v) for k, v in specs["blocks"].items()]


def test_parallel_step_equals_jax_on_the_same_mesh(jax_mesh_ref, port_runs):
    name, losses, final = jax_mesh_ref
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], losses, atol=SAME_MESH_TOL, rtol=0)
    _assert_trees(run["final"], final, SAME_MESH_TOL, name)


@pytest.mark.parametrize("name", list(MESHES))
def test_parallel_step_equals_single_device_sgd(name, single_device, port_runs):
    run = port_runs[name]
    np.testing.assert_allclose(run["losses"], single_device["losses"], atol=SGD_LOSS_TOL)
    _assert_trees(run["final"], single_device["final"], SGD_PARAM_TOL, name)


@pytest.mark.parametrize("name", list(MESHES))
def test_one_step_gradients_leaf_by_leaf(name, single_device, port_runs):
    """The gradients summed as ``grad_sum_axes`` says equal single-device
    autograd of the global mean loss: a sum taken twice would scale a
    leaf by an axis size, a missing one would leave a partial sum."""
    run = port_runs[name]
    np.testing.assert_allclose(run["loss0"], single_device["losses"][0], atol=SAME_MESH_TOL)
    for (path, got), (_p, want) in zip(sorted_leaves(run["grads"]),
                                       sorted_leaves(single_device["grads"])):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=f"{name} {path}")


def test_moe_ep_step_equals_jax_ep_step(jax_moe_ref, port_runs):
    losses, final = jax_moe_ref
    run = port_runs["moe"]
    np.testing.assert_allclose(run["losses"], losses, atol=SAME_MESH_TOL, rtol=0)
    _assert_trees(run["final"], final, SAME_MESH_TOL, "moe")
    assert all(np.isfinite(run["losses"]))
    assert run["losses"][-1] < run["losses"][0]


def test_dryrun_multichip_on_eight_cpu_ranks(capsys):
    runs = dryrun_multichip(8, device="cpu")
    assert [ax for ax, _loss in runs] == dryrun_factorizations(8) == [
        {"data": 1, "stage": 2, "seq": 2, "model": 2},
        {"data": 2, "stage": 2, "seq": 1, "model": 2}]
    assert all(np.isfinite(loss) for _ax, loss in runs)
    assert capsys.readouterr().out.count("dryrun_multichip ok") == 2


def test_dryrun_multichip_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(8)
