"""The port's mesh, collectives, ring attention and GPipe
(``seldon_core_tpu_torch/parallel``) against the JAX package.

The pure helpers are compared with the JAX functions on the JAX tests'
inputs, errors included. The rest runs on 4 gloo ranks spawned once for
the module (``tests/_torch_ranks.py``, no JAX in the children); the JAX
references run in this process under ``shard_map`` over 4 of the 8
virtual CPU devices, and every rank's output and gradients are held
against them at float32:

* ring attention (causal and not, and at ring size 1): 2e-5 on outputs
  and 1e-4 on gradients, the JAX tests' own tolerances
  (``tests/test_parallel.py``);
* each collective's backward against its JAX transpose: 1e-6 (sums of a
  few float32 terms);
* GPipe at 2 stages and 2 microbatches against the same stages run one
  after the other: 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import torch

from seldon_core_tpu.parallel import mesh as jax_mesh
from seldon_core_tpu.parallel.ring import full_attention as jax_full
from seldon_core_tpu.parallel.ring import ring_attention as jax_ring
from seldon_core_tpu.parallel.vma import pvary as jax_pvary
from seldon_core_tpu_torch.parallel import mesh as port_mesh
from seldon_core_tpu_torch.parallel.launch import launch
from seldon_core_tpu_torch.parallel.ring import full_attention

import _torch_ranks

RING_TOL, RING_GRAD_TOL = 2e-5, 1e-4
COLL_TOL = 1e-6
PIPE_TOL = 1e-6
N = 4


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the error's type and text are compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 16, 32, 12, 0, -4, "8"])
def test_factor_devices_equals_jax(n):
    assert _outcome(port_mesh.factor_devices, n) == _outcome(jax_mesh.factor_devices, n)


@pytest.mark.parametrize("raw", [
    "data=2,model=4", " model=8 ", "data=1,stage=2,seq=1,model=4",
    "", "data", "data=", "data=x", "data=0", "data=-2", "data=2,data=4", "rows=2",
    "data=2,,model=4", "data=2.5", 7,
])
def test_parse_mesh_shape_equals_jax(raw):
    assert _outcome(port_mesh.parse_mesh_shape, raw) == _outcome(jax_mesh.parse_mesh_shape, raw)


@pytest.mark.parametrize("args", [
    ({"data": 2, "model": 4}, 4, 64), ({"model": 8}, 4, 64), ({"model": 4}, 4, 66),
    ({"model": 4}, 4, 64, 2), ({"model": 1}, 3, 5), ({}, 3, 5),
])
def test_validate_model_dims_equals_jax(args):
    assert (_outcome(port_mesh.validate_model_dims, *args)
            == _outcome(jax_mesh.validate_model_dims, *args))


def test_mesh_shape_error_is_a_value_error():
    assert issubclass(port_mesh.MeshShapeError, ValueError)


@pytest.mark.parametrize("shape", [{"model": 0}, {"data": -2}, {"model": "4"}, {"rows": 2}])
def test_make_mesh_refuses_bad_axes_before_any_group(shape):
    """Sizes are checked before a process group is asked for (none exists
    in this process); an axis outside data/stage/seq/model is refused."""
    with pytest.raises(port_mesh.MeshShapeError):
        port_mesh.make_mesh(shape)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        port_mesh.make_mesh({"data": 1})


def test_initialize_distributed_noop_without_coordinator(monkeypatch):
    for var in ("SELDON_TPU_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert port_mesh.initialize_distributed() is False


def test_initialize_distributed_refuses_without_cuda(monkeypatch, tmp_path):
    """The default backend is NCCL on the card: a coordinator given on a
    machine without CUDA raises, never continuing as one process."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setenv("SELDON_TPU_COORDINATOR", f"file://{tmp_path}/rdv")
    monkeypatch.setenv("SELDON_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("SELDON_TPU_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mesh.initialize_distributed()


def test_initialize_distributed_needs_world_and_rank(monkeypatch):
    for var in ("SELDON_TPU_NUM_PROCESSES", "SELDON_TPU_PROCESS_ID", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="world size"):
        port_mesh.initialize_distributed("127.0.0.1:1", backend="gloo")


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    B, H, T, Dh = 2, 4, 32, 16
    f = np.float32
    return {
        "q": rs.randn(B, H, T, Dh).astype(f), "k": rs.randn(B, H, T, Dh).astype(f),
        "v": rs.randn(B, H, T, Dh).astype(f), "w_ring": rs.randn(B, H, T, Dh).astype(f),
        "x": rs.randn(N, 6, 5).astype(f), "w": rs.randn(N, 6, 5).astype(f),
        "const": rs.randn(6, 5).astype(f),
        "a2a0": rs.randn(N, 4, 2, 3, 5).astype(f), "wa0": rs.randn(N, 1, 2, 12, 5).astype(f),
        "a2a1": rs.randn(N, 2, 4, 3, 5).astype(f), "wa1": rs.randn(N, 8, 1, 3, 5).astype(f),
        "W": (rs.randn(2, 8, 8) / np.sqrt(8)).astype(f),
        "x_pipe": rs.randn(2, 3, 8).astype(f), "w_pipe": rs.randn(2, 3, 8).astype(f),
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    return launch(_torch_ranks.parallel_checks, N, args=(inputs,), backend="gloo",
                  timeout_s=300)


def _jmesh(shape):
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:N])


def _jax_grads(fn, in_specs, out_spec, w, *xs, mesh_shape=None):
    """(output, grads) of ``sum(shard_map(fn)(*xs) * w)`` on a mesh of 4."""
    f = jax.shard_map(fn, mesh=_jmesh(mesh_shape or {"seq": N}), in_specs=in_specs,
                      out_specs=out_spec)
    xs = [jnp.asarray(x) for x in xs]
    out = f(*xs)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=tuple(range(len(xs))))(*xs)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_make_mesh_refusals_on_four_ranks(ranks):
    """The world-size refusals, word for word JAX's over 4 devices."""
    for shape in ({"data": 8}, {"data": 3}):
        try:
            jax_mesh.make_mesh(shape, devices=jax.devices()[:N])
            want = None
        except jax_mesh.MeshShapeError as e:
            want = str(e)
        assert want is not None
        for r in ranks:
            assert r[f"refuse {shape}"] == want


def test_make_mesh_of_part_of_the_world(ranks):
    """A mesh of 2 on 4 ranks takes ranks 0 and 1, as JAX takes the first
    devices; the others lie outside it and refuse to act in it."""
    for r, res in enumerate(ranks):
        coords, got = res["sub-mesh"]
        if r < 2:
            assert coords == {"data": r, "stage": 0, "seq": 0, "model": 0} and got == [0, 1]
        else:
            assert coords is None and "outside the mesh" in got


def test_rank_r_holds_jax_device_r(ranks):
    """Port rank r sits where JAX device r sits: the same coordinates, and
    the linear (data, seq) index data-major."""
    for shape, key in (({"data": 2, "seq": 2}, "grid"), ({"data": 2, "stage": 2}, "pipe")):
        jm = _jmesh(shape)
        for coords in np.ndindex(*jm.devices.shape):
            r = jm.devices[coords].id
            assert ranks[r]["coords"][key] == {
                **{ax: 0 for ax in port_mesh.AXES}, **dict(zip(jm.axis_names, coords))}
    for r, res in enumerate(ranks):
        got = res["axis_index"]
        d, s = got["data"], got["seq"]
        assert got["data,seq"] == d * 2 + s and got["size data,seq"] == 4
        assert ranks[r]["coords"]["grid"] == {"data": d, "stage": 0, "seq": s, "model": 0}


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_equals_jax_and_full(ranks, inputs, causal):
    spec = P(None, None, "seq", None)
    w = jnp.asarray(inputs["w_ring"])
    want, wgrads = _jax_grads(lambda q, k, v: jax_ring(q, k, v, "seq", causal=causal),
                              (spec,) * 3, spec, w, inputs["q"], inputs["k"], inputs["v"])
    full = full_attention(*(torch.as_tensor(inputs[n]) for n in "qkv"), causal=causal).numpy()
    jfull = np.asarray(jax_full(*(jnp.asarray(inputs[n]) for n in "qkv"), causal=causal))
    np.testing.assert_allclose(full, jfull, atol=RING_TOL)
    C = inputs["q"].shape[2] // N
    for r, res in enumerate(ranks):
        out, grads = res[f"ring causal={causal}"]
        sl = slice(r * C, (r + 1) * C)
        np.testing.assert_allclose(out, want[:, :, sl], atol=RING_TOL)
        np.testing.assert_allclose(out, full[:, :, sl], atol=RING_TOL)
        for g, wg in zip(grads, wgrads):
            np.testing.assert_allclose(g, wg[:, :, sl], atol=RING_GRAD_TOL)


def test_ring_attention_size_one_is_full_attention(ranks, inputs):
    spec = P(None, None, "seq", None)
    w = jnp.asarray(inputs["w_ring"])
    want, wgrads = _jax_grads(lambda q, k, v: jax_ring(q, k, v, "seq"), (spec,) * 3, spec, w,
                              inputs["q"], inputs["k"], inputs["v"],
                              mesh_shape={"data": N, "seq": 1})
    for res in ranks:
        out, grads = res["ring size 1"]
        np.testing.assert_allclose(out, want, atol=RING_TOL)
        for g, wg in zip(grads, wgrads):
            np.testing.assert_allclose(g, wg, atol=RING_GRAD_TOL)


def _blocks(a):
    """[N * m, ...] global -> N per-rank blocks along axis 0."""
    return np.split(np.asarray(a), N, axis=0)


@pytest.mark.parametrize("name", ["psum", "pmean", "pvary", "ppermute ring", "ppermute chain",
                                  "all_to_all 0->2", "all_to_all 1->0"])
def test_collective_backward_is_the_jax_transpose(ranks, inputs, name):
    x = inputs["x"].reshape(N * 6, 5)
    w = jnp.asarray(inputs["w"].reshape(N * 6, 5))
    const = jnp.asarray(inputs["const"])
    if name == "psum":
        want, (g,) = _jax_grads(lambda x: lax.psum(x, "seq"), P("seq"), P(), const, x)
        outs, grads = [want] * N, _blocks(g)
    elif name == "pmean":
        want, (g,) = _jax_grads(lambda x: lax.pmean(x, "seq"), P("seq"), P(), const, x)
        outs, grads = [want] * N, _blocks(g)
    elif name == "pvary":
        want, (g,) = _jax_grads(lambda x: jax_pvary(x, "seq"), P(), P("seq"), w,
                                inputs["x"][0])
        outs, grads = _blocks(want), [g] * N
    elif name.startswith("ppermute"):
        perm = ([(i, (i + 1) % N) for i in range(N)] if name.endswith("ring")
                else [(0, 1), (1, 2), (2, 3)])
        want, (g,) = _jax_grads(lambda x: lax.ppermute(x, "seq", perm), P("seq"), P("seq"), w, x)
        outs, grads = _blocks(want), _blocks(g)
    elif name == "all_to_all 0->2":
        a = inputs["a2a0"].reshape(N * 4, 2, 3, 5)
        wa = jnp.asarray(inputs["wa0"].reshape(N, 2, 12, 5))
        want, (g,) = _jax_grads(lambda a: lax.all_to_all(a, "seq", 0, 2, tiled=True),
                                P("seq"), P("seq"), wa, a)
        outs, grads = _blocks(want), _blocks(g)
    else:
        a = inputs["a2a1"].reshape(N * 2, 4, 3, 5)
        wa = jnp.asarray(inputs["wa1"].reshape(N * 8, 1, 3, 5))
        want, (g,) = _jax_grads(lambda a: lax.all_to_all(a, "seq", 1, 0, tiled=True),
                                P("seq"), P("seq"), wa, a)
        outs, grads = _blocks(want), _blocks(g)
    for r, res in enumerate(ranks):
        out, (grad,) = res[name]
        np.testing.assert_allclose(out, outs[r], atol=COLL_TOL, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(grad, grads[r], atol=COLL_TOL, err_msg=f"{name} rank {r}")


def test_gpipe_two_stages_equals_sequential(ranks, inputs):
    """S 2, M 2 on {data 2, stage 2}: the last stage's outputs and every
    gradient equal the two stages run one after the other; stage 0's
    outputs are zeros and only stage 0 reads the input."""
    W = [torch.tensor(w, requires_grad=True) for w in inputs["W"]]
    x = torch.tensor(inputs["x_pipe"], requires_grad=True)
    out = torch.tanh(torch.tanh(x @ W[0]) @ W[1])
    dW0, dW1, dx = torch.autograd.grad((out * torch.as_tensor(inputs["w_pipe"])).sum(),
                                       [W[0], W[1], x])
    want = out.detach().numpy()
    for res in ranks:
        stage = res["coords"]["pipe"]["stage"]
        got, (gW, gx) = res["gpipe"]
        np.testing.assert_allclose(got, want if stage == 1 else np.zeros_like(want),
                                   atol=PIPE_TOL)
        np.testing.assert_allclose(gW, (dW0, dW1)[stage].numpy(), atol=PIPE_TOL)
        np.testing.assert_allclose(gx, dx.numpy() if stage == 0 else np.zeros_like(gx),
                                   atol=PIPE_TOL)


def test_hybrid_mesh_one_node_is_flat(ranks):
    """On one node the hybrid mesh is make_mesh over the merged shape, as
    JAX's is on one slice (the CPU devices)."""
    jm = jax_mesh.make_hybrid_mesh({"model": 2}, {"data": 2}, devices=jax.devices()[:N])
    ids = np.vectorize(lambda d: d.id)(jm.devices).tolist()
    for res in ranks:
        assert res["hybrid flat"] == {"names": tuple(jm.axis_names), "ranks": ids}


def test_hybrid_mesh_across_nodes_and_ep_order(ranks):
    """Two nodes of two ranks, ``seq`` across nodes and ``data`` within:
    a rank's coordinate on an axis is its node's times the per-node size
    plus its own within the node. The (data, seq) expert axis is then not
    in ascending rank order ([0, 2, 1, 3]), and all_to_all still trades
    blocks by data-major index."""
    members = [0, 2, 1, 3]
    for r, res in enumerate(ranks):
        got = res["hybrid"]
        assert got["names"] == ("seq", "data") and got["ranks"] == [[0, 1], [2, 3]]
        assert got["ep members"] == members and got["ep index"] == members.index(r)
        rows = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
        want = np.stack([rows[got["ep index"]] + 100 * m for m in members])
        np.testing.assert_array_equal(got["a2a"], want)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, None), (True, 20), (False, 7)])
def test_full_attention_equals_jax(inputs, causal, kv_len):
    """The one-device attention of the training forward (``loss_fn``),
    output and gradients, with and without a key-length mask."""
    qkv = [torch.tensor(inputs[n], requires_grad=True) for n in "qkv"]
    out = full_attention(*qkv, causal=causal, kv_len=kv_len)
    grads = torch.autograd.grad((out * torch.as_tensor(inputs["w_ring"])).sum(), qkv)
    w = jnp.asarray(inputs["w_ring"])
    jqkv = [jnp.asarray(inputs[n]) for n in "qkv"]
    want = jax_full(*jqkv, causal=causal, kv_len=kv_len)
    wgrads = jax.grad(lambda *a: jnp.sum(jax_full(*a, causal=causal, kv_len=kv_len) * w),
                      argnums=(0, 1, 2))(*jqkv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=RING_TOL)
    for g, wg in zip(grads, wgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=RING_GRAD_TOL)
