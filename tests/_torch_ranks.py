"""Rank workers of the port's multi-rank CPU tests (gloo, spawned by
``seldon_core_tpu_torch.parallel.launch.launch``).

No JAX here: every spawned rank imports this module, and a child that
imported JAX would pay for it eight times over. The tests compute the JAX
references in the parent and hand numpy arrays across.
"""

import os

import numpy as np
import torch

from seldon_core_tpu_torch.models.llm import DecoderLM
from seldon_core_tpu_torch.parallel import collectives as C
from seldon_core_tpu_torch.parallel.mesh import MeshShapeError, make_hybrid_mesh, make_mesh
from seldon_core_tpu_torch.parallel.pipeline import gpipe
from seldon_core_tpu_torch.parallel.ring import ring_attention
from seldon_core_tpu_torch.parallel.train import gather_params, make_train_step, shard_params


def _chunk(a, axis, n, i):
    w = a.shape[axis] // n
    return torch.as_tensor(np.take(a, range(i * w, (i + 1) * w), axis=axis))


def _leaf_grads(fn, *xs):
    """(output, grads) of ``fn`` over fresh leaf copies of ``xs``, the
    loss being ``sum(output * w)`` for the ``w`` ``fn`` returns."""
    xs = [x.clone().requires_grad_(True) for x in xs]
    out, w = fn(*xs)
    grads = torch.autograd.grad((out * w).sum(), xs)
    return out.detach().numpy(), [g.numpy() for g in grads]


def parallel_checks(rank, inp):
    """Four ranks: make_mesh's refusals, ring attention, the collectives'
    backward and GPipe. Returns this rank's numbers."""
    res = {}
    for shape in ({"data": 8}, {"data": 3}):
        try:
            make_mesh(shape)
            res[f"refuse {shape}"] = None
        except MeshShapeError as e:
            res[f"refuse {shape}"] = str(e)

    sub = make_mesh({"data": 2})  # two of the four ranks, as JAX's first devices
    try:
        res["sub-mesh"] = (sub.coords, sub.axis("data").members)
    except RuntimeError as e:
        res["sub-mesh"] = (sub.coords, str(e))

    mesh = make_mesh({"seq": 4})
    seq = mesh.axis("seq")
    q, k, v = inp["q"], inp["k"], inp["v"]
    for causal in (True, False):
        res[f"ring causal={causal}"] = _leaf_grads(
            lambda q, k, v: (ring_attention(q, k, v, seq, causal=causal),
                             torch.as_tensor(_chunk(inp["w_ring"], 2, 4, seq.index))),
            *(_chunk(t, 2, 4, seq.index) for t in (q, k, v)))

    one = make_mesh({"data": 4, "seq": 1})
    res["ring size 1"] = _leaf_grads(
        lambda q, k, v: (ring_attention(q, k, v, one.axis("seq")), torch.as_tensor(inp["w_ring"])),
        *(torch.as_tensor(t) for t in (q, k, v)))

    x = torch.as_tensor(inp["x"][seq.index])  # this rank's [6, 5] block
    w = torch.as_tensor(inp["w"][seq.index])
    const = torch.as_tensor(inp["const"])
    res["psum"] = _leaf_grads(lambda x: (C.psum(x, seq), const), x)
    res["pvary"] = _leaf_grads(lambda x: (C.pvary(x, seq), w), torch.as_tensor(inp["x"][0]))
    res["pmean"] = _leaf_grads(lambda x: (C.pmean(x, seq), const), x)
    for name, perm in (("ring", C.ring_perm(4)), ("chain", [(0, 1), (1, 2), (2, 3)])):
        res[f"ppermute {name}"] = _leaf_grads(lambda x: (C.ppermute(x, seq, perm), w), x)
    a = torch.as_tensor(inp["a2a0"][seq.index])  # [4, 2, 3, 5]
    res["all_to_all 0->2"] = _leaf_grads(
        lambda a: (C.all_to_all(a, seq, 0, 2), torch.as_tensor(inp["wa0"][seq.index])), a)
    b = torch.as_tensor(inp["a2a1"][seq.index])  # [2, 4, 3, 5]
    res["all_to_all 1->0"] = _leaf_grads(
        lambda b: (C.all_to_all(b, seq, 1, 0), torch.as_tensor(inp["wa1"][seq.index])), b)

    grid = make_mesh({"data": 2, "seq": 2})
    res["axis_index"] = {"data": C.axis_index(grid.axis("data")),
                         "seq": C.axis_index(grid.axis("seq")),
                         "data,seq": C.axis_index(grid.axis(("data", "seq"))),
                         "size data,seq": C.axis_size(grid.axis(("data", "seq")))}

    pipe = make_mesh({"data": 2, "stage": 2})
    stage = pipe.axis("stage")
    W = torch.as_tensor(inp["W"][stage.index])
    res["gpipe"] = _leaf_grads(
        lambda W, x: (gpipe(lambda W, xx: torch.tanh(xx @ W), W, x, stage),
                      torch.as_tensor(inp["w_pipe"])),
        W, torch.as_tensor(inp["x_pipe"]))
    res["coords"] = {"pipe": dict(pipe.coords), "grid": dict(grid.coords)}

    flat = make_hybrid_mesh({"model": 2}, {"data": 2})  # one node: a flat mesh
    res["hybrid flat"] = {"names": flat.axis_names, "ranks": flat.ranks.tolist()}
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two nodes of two ranks
    try:
        hy = make_hybrid_mesh({"data": 2}, {"seq": 2})
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    ep = hy.axis(("data", "seq"))
    rows = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3) + 100 * rank
    res["hybrid"] = {"names": hy.axis_names, "ranks": hy.ranks.tolist(),
                     "ep members": ep.members, "ep index": ep.index,
                     "a2a": C.all_to_all(rows, ep, 0, 0).numpy()}
    return res


def train_runs(rank, jobs):
    """Eight ranks: for each job one step's gradients, then ``steps``
    SGD steps of ``make_train_step`` from the given full parameters.
    Returns per job the losses (every rank) and, on rank 0, the gathered
    gradients and final parameters."""
    out = {}
    for job in jobs:
        mesh = make_mesh(job["mesh"])
        model = DecoderLM(**job["cfg"])
        _init, step = make_train_step(model, mesh, n_microbatches=2,
                                      learning_rate=job["lr"], device="cpu")
        params = shard_params(job["params"], mesh, "cpu")
        loss0, grads = step.value_and_grad(params, job["tokens"])
        grads = gather_params(grads, mesh)
        losses = []
        for _ in range(job["steps"]):
            params, loss = step(params, job["tokens"])
            losses.append(float(loss))
        final = gather_params(params, mesh)
        out[job["name"]] = {"loss0": float(loss0), "losses": losses,
                            "grads": grads if rank == 0 else None,
                            "final": final if rank == 0 else None}
    return out
