"""Lease leader election in the port's operator
(seldon_core_tpu_torch/controlplane/kube.py ``LeaderElector``) held
against the JAX package's on the CPU.

Counterpart of tests/test_leader_election.py: two replicas of each
package against one in-memory kube API each, driven by the same injected
clock through the same rounds, take the same transitions and write the
same leases; only the leader reconciles and a follower takes over a
lapsed lease."""

import pytest

from _torch_tools import JAX, PKGS, PORT, fake_kube, m

LEASE = "apis/coordination.k8s.io/v1/namespaces/default/leases/seldon-tpu-controller"


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def electors(pkg, api, clock, duration=15):
    k = m(pkg, "controlplane.kube")
    return tuple(k.LeaderElector(api, identity=f"replica-{x}", lease_duration_s=duration,
                                 clock=clock) for x in "ab")


# each round: (seconds to advance, which replica tries)
ROUNDS = {
    "acquire-follow": [(0, "a"), (0, "b"), (5, "b"), (5, "a")],
    "renew-within": [(0, "a"), (10, "a"), (10, "b"), (4, "a"), (14, "b")],
    "steal-lapsed": [(0, "a"), (16, "b"), (0, "a"), (1, "b"), (16, "a"), (0, "b")],
    "malformed-lease": [(0, "a"), ("corrupt", None), (0, "b"), (0, "a")],
}


def transitions(pkg, name):
    api = fake_kube(pkg)
    clock = Clock()
    a, b = electors(pkg, api, clock)
    out = []
    for dt, who in ROUNDS[name]:
        if dt == "corrupt":
            api.objects[LEASE]["spec"]["renewTime"] = "not a time"
            continue
        clock.t += dt
        e = a if who == "a" else b
        out.append((who, e.try_acquire(), a.is_leader, b.is_leader,
                    api.objects[LEASE]["spec"]))
    return out, api.calls


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_elector_transitions_equal_jax(name):
    assert transitions(PORT, name) == transitions(JAX, name)


def test_follower_steals_lapsed_lease():
    api = fake_kube(PORT)
    clock = Clock()
    a, b = electors(PORT, api, clock)
    assert a.try_acquire()
    clock.t += 16
    assert b.try_acquire() and b.is_leader
    assert not a.try_acquire() and not a.is_leader
    assert api.objects[LEASE]["spec"]["holderIdentity"] == "replica-b"
    assert api.objects[LEASE]["spec"]["leaseTransitions"] == 1


def cr(name="m"):
    return {"apiVersion": "machinelearning.seldon.io/v1alpha2", "kind": "SeldonDeployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"name": name, "predictors": [
                {"name": "default", "replicas": 1, "graph": {"name": "clf", "type": "MODEL"}}]}}


def takeover(pkg):
    k = m(pkg, "controlplane.kube")
    api = fake_kube(pkg)
    clock = Clock()
    ea, eb = electors(pkg, api, clock)
    ctl_a = k.KubeController(api, resync_s=0.01, elector=ea)
    ctl_b = k.KubeController(api, resync_s=0.01, elector=eb)
    ctl_a.install_crd()
    api.create(k.object_path("SeldonDeployment", "default"), cr())
    assert ea.try_acquire()
    api.reset_calls()
    steps = []
    assert not eb.try_acquire()
    ctl_b.run(iterations=1)
    steps.append(list(api.writes()))
    ctl_a.run(iterations=1)
    steps.append(list(api.writes()))
    api.objects.pop("apis/apps/v1/namespaces/default/deployments/m-default", None)
    clock.t += 16
    api.reset_calls()
    ctl_b.run(iterations=1)
    steps.append((eb.is_leader, list(api.writes())))
    return steps


def test_only_leader_reconciles_follower_takes_over_as_jax():
    want, got = (takeover(pkg) for pkg in PKGS)
    assert got == want
    follower, leader, (b_leads, after) = got
    assert follower == []
    assert any("deployments" in p for _v, p in leader)
    # the new leader re-creates the Deployment the test removed
    assert b_leads and ("create", "apis/apps/v1/namespaces/default/deployments") in after
