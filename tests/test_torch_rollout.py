"""The port's progressive delivery (seldon_core_tpu_torch/rollout/) held
against the JAX package's on the CPU.

Mirrors tests/test_rollout.py (its weight-swap cases are the serving
layer's, held in tests/test_torch_migration.py): ``plan_from_deployment``
on good and malformed annotations, the ``RolloutController`` state
machine on the same synthetic metric totals (verdict, weights, phase and
event trail after every tick, across restarts), ``diff_responses`` on
token and tensor pairs, the ``ShadowMirror``'s counts, and the
reconciler's mirror wiring and canary re-route. Each scenario runs
through both packages and the traces must be equal.
"""

import asyncio
import importlib
import json

import pytest

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
PKGS = (JAX, PORT)


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(coro)


def rollout_dep(pkg, mode="canary", steps="25,100", interval="5", extra=None,
                candidate_traffic=0, name="dep"):
    """Two-predictor deployment: live baseline + annotated candidate."""
    ann = {"seldon.io/rollout": mode, "seldon.io/rollout-steps": steps,
           "seldon.io/rollout-interval-s": interval,
           "seldon.io/rollout-min-samples": "3", **(extra or {})}
    cand = {"name": "canary", "traffic": candidate_traffic, "annotations": ann,
            "graph": {"name": "clf", "implementation": "SIMPLE_MODEL"}}
    if mode == "shadow":
        cand["annotations"]["seldon.io/shadow"] = "true"
        cand["traffic"] = 0
    return m(pkg, "controlplane").SeldonDeployment.from_dict({
        "name": name,
        "predictors": [
            {"name": "baseline", "traffic": 100 - cand["traffic"],
             "graph": {"name": "clf", "implementation": "SIMPLE_MODEL"}},
            cand,
        ],
    })


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the outcome is the datum
        return ("raise", type(e).__name__, str(e))


# -- plan parsing ------------------------------------------------------------


def _plan(pkg, **kw):
    plan = m(pkg, "rollout").plan_from_deployment(rollout_dep(pkg, **kw))
    return None if plan is None else json.loads(json.dumps(
        {f: getattr(plan, f) for f in plan.__dataclass_fields__}))


PLAN_CASES = [
    dict(steps="5,25,50,100", interval="30"),
    dict(mode="shadow", steps="6"),
    dict(mode="shadow", steps="5,25,100"),
    dict(mode="shadow", steps="0"),
    dict(steps=""), dict(steps="0,50"), dict(steps="50,25"), dict(steps="25,200"),
    dict(steps="a,b"), dict(steps="100"),
    dict(mode="blue-green"),
    dict(extra={"seldon.io/rollout-max-error-delta": "-1"}),
    dict(extra={"seldon.io/rollout-max-ttft-ratio": "x"}),
    dict(extra={"seldon.io/rollout-min-samples": "0"}),
    dict(extra={"seldon.io/rollout-max-latency-ratio": "2.5",
                "seldon.io/rollout-max-divergence": "0.1"}),
    dict(interval="0"),
    dict(candidate_traffic=10),
]


@pytest.mark.parametrize("kw", PLAN_CASES, ids=[str(i) for i in range(len(PLAN_CASES))])
def test_plan_from_deployment_agrees(kw):
    got = {pkg: outcome(lambda p=pkg: _plan(p, **kw)) for pkg in PKGS}
    assert got[PORT] == got[JAX]


def test_plan_shape_rules_agree():
    """No annotation gives no plan; a shadow plan needs the shadow flag; a
    canary on a shadow predictor, two candidates or no baseline refuse."""
    def cases(pkg):
        spec = m(pkg, "graph.spec")
        out = []
        plain = rollout_dep(pkg)
        for p in plain.predictors:
            p.annotations.pop("seldon.io/rollout", None)
        out.append(outcome(m(pkg, "rollout").plan_from_deployment, plain))
        noflag = rollout_dep(pkg, mode="shadow")
        noflag.predictor("canary").annotations.pop("seldon.io/shadow")
        out.append(outcome(m(pkg, "rollout").plan_from_deployment, noflag))
        onshadow = rollout_dep(pkg)
        onshadow.predictor("canary").annotations["seldon.io/shadow"] = "true"
        out.append(outcome(m(pkg, "rollout").plan_from_deployment, onshadow))
        two = rollout_dep(pkg)
        two.predictor("baseline").annotations["seldon.io/rollout"] = "canary"
        out.append(outcome(m(pkg, "rollout").plan_from_deployment, two))
        alone = rollout_dep(pkg)
        alone.predictors = [alone.predictor("canary")]
        out.append(outcome(m(pkg, "rollout").plan_from_deployment, alone))
        bad = rollout_dep(pkg, steps="5,x")
        out.append(outcome(spec.validate_deployment, bad.predictors))
        return [o if o[0] == "raise" else ("ok", o[1] is None) for o in out]

    got = {pkg: cases(pkg) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == ("ok", True) and all(o[0] == "raise" for o in got[PORT][1:])


# -- the controller's state machine on the same totals ---------------------


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Kit:
    """One package's rollout controller over a fresh store, with the
    metric feed and the observables a scenario records."""

    def __init__(self, pkg, dep):
        self.pkg = pkg
        ctl_mod = m(pkg, "rollout.controller")
        self.REQUESTS, self.ERRORS, self.TTFT = (
            ctl_mod.REQUESTS, ctl_mod.ERRORS, ctl_mod.TTFT_HIST)
        self.store = m(pkg, "controlplane").ResourceStore()
        self.store.apply(dep)
        self.clock = Clock()
        self.reg = m(pkg, "graph.engine_metrics").MetricsRegistry()
        self.ctl = self.fresh()
        self.trace = []

    def fresh(self):
        return m(self.pkg, "rollout").RolloutController(
            self.store, metrics=self.reg, now=self.clock)

    def feed(self, name, requests=10, errors=0, ttft=None):
        self.reg.counter_inc(self.REQUESTS, {"deployment": name}, requests)
        if errors:
            self.reg.counter_inc(self.ERRORS, {"deployment": name}, errors)
        for t in ttft or []:
            self.reg.observe(self.TTFT, t, {"deployment": name})

    def mirror(self, name, n):
        self.reg.counter_inc(name, {"deployment": "default/dep", "predictor": "canary"}, n)

    def tick(self, dt=0.0):
        self.clock.t += dt
        verdicts = self.ctl.tick_all()
        dep = self.store.get("dep")
        st = self.ctl.state("default/dep")
        self.trace.append({
            "verdicts": verdicts,
            "weights": None if dep is None else {p.name: p.traffic for p in dep.predictors},
            "phase": None if st is None else st.phase,
            "step": None if st is None else st.step_ix,
            "events": None if st is None else [
                {k: v for k, v in e.items() if k not in ("t", "wall_us")} for e in st.events],
            "checkpoint": None if dep is None else dep.status.rollout is not None,
        })
        return verdicts


def healthy(k, **kw):
    k.feed("baseline", requests=20, **kw)
    k.feed("canary", requests=20, **kw)


SCENARIOS = {
    "promote-through-steps": lambda k: [
        k.tick(), healthy(k), k.tick(5), healthy(k), k.tick(5), k.tick(5)],
    "pause-on-few-samples": lambda k: [
        k.tick(), k.feed("baseline", requests=50), k.feed("canary", requests=1), k.tick(5)],
    "error-rollback": lambda k: [
        k.tick(), k.feed("baseline", requests=40), k.feed("canary", requests=10, errors=5),
        k.tick(5), healthy(k), k.tick(5)],
    "ttft-rollback": lambda k: [
        k.tick(), k.feed("baseline", requests=20, ttft=[0.1] * 10),
        k.feed("canary", requests=20, ttft=[0.3] * 10), k.tick(5)],
    "ttft-skipped": lambda k: [k.tick(), healthy(k), k.tick(5)],
    "idle-baseline": lambda k: [
        k.tick(), k.feed("baseline", requests=20, errors=2),
        k.feed("canary", requests=18, errors=2), k.tick(5),
        k.feed("canary", requests=18, errors=2), k.tick(5)],
    "capacity-at-full": lambda k: [
        k.tick(), healthy(k), k.tick(5), k.feed("canary", requests=2, errors=18), k.tick(5)],
    "latency-at-full": lambda k: [
        k.tick(), healthy(k, ttft=[0.1] * 10), k.tick(5),
        k.feed("canary", requests=20, ttft=[0.5] * 10), k.tick(5)],
    "restart-mid-ramp": lambda k: [
        k.tick(), healthy(k), k.tick(5), setattr(k, "ctl", k.fresh()), k.tick(1),
        k.feed("baseline", requests=20), k.feed("canary", requests=10, errors=10), k.tick(5)],
    "restart-then-capacity": lambda k: [
        k.tick(), healthy(k), k.tick(5), setattr(k, "ctl", k.fresh()), k.tick(),
        k.feed("canary", requests=2, errors=18), k.tick(5)],
    "promoted-stays-terminal": lambda k: [
        k.tick(), healthy(k), k.tick(5), healthy(k), k.tick(5),
        setattr(k, "ctl", k.fresh()), k.tick(50)],
    "edit-restarts": lambda k: [
        k.tick(), healthy(k), k.tick(5), _edit(k, "10,100"), k.tick()],
    "edit-keeps-rollback-baseline": lambda k: [
        k.tick(), healthy(k), k.tick(5), _edit(k, "50,100"), k.tick(),
        k.feed("baseline", requests=20), k.feed("canary", requests=10, errors=10), k.tick(5)],
    "deleted-drops-state": lambda k: [k.tick(), k.store.delete("dep"), k.tick()],
    "shadow-promote-then-fail": lambda k: [
        k.tick(), k.mirror("seldon_rollout_mirrors", 10), k.tick(5),
        k.mirror("seldon_rollout_mirrors", 10), k.mirror("seldon_rollout_divergence", 2),
        k.tick(5)],
    "shadow-mirror-errors": lambda k: [
        k.tick(), k.mirror("seldon_rollout_mirror_errors", 10), k.tick(5)],
    "shadow-zero-divergence-promotes": lambda k: [
        k.tick(), k.mirror("seldon_rollout_mirrors", 4), k.tick(5),
        k.mirror("seldon_rollout_mirrors", 4), k.tick(5)],
}

SHADOW = {"shadow-promote-then-fail", "shadow-mirror-errors", "shadow-zero-divergence-promotes"}


def _edit(k, steps):
    dep = k.store.get("dep").clone()
    dep.predictor("canary").annotations["seldon.io/rollout-steps"] = steps
    k.store.apply(dep)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rollout_controller_verdicts_equal(name):
    traces = {}
    for pkg in PKGS:
        kw = dict(mode="shadow", steps="25,100") if name in SHADOW else dict(steps="25,100")
        if name == "restart-mid-ramp":
            kw["steps"] = "25,50,100"
        k = Kit(pkg, rollout_dep(pkg, **kw))
        SCENARIOS[name](k)
        traces[pkg] = (k.trace, k.reg.expose().count("seldon_rollout_verdicts"))
    assert traces[PORT] == traces[JAX]
    verdicts = [v for t in traces[PORT][0] for v in t["verdicts"].values()]
    assert verdicts and verdicts[0] == "start"


def test_invalid_plan_does_not_kill_other_rollouts():
    got = {}
    for pkg in PKGS:
        store = m(pkg, "controlplane").ResourceStore()
        store.apply(rollout_dep(pkg, steps="100,50", name="bad"))
        store.apply(rollout_dep(pkg, steps="25,100", name="good"))
        ctl = m(pkg, "rollout").RolloutController(
            store, metrics=m(pkg, "graph.engine_metrics").MetricsRegistry(), now=Clock())
        got[pkg] = ctl.tick_all()
    assert got[PORT] == got[JAX] == {"default/good": "start"}


# -- divergence differ -------------------------------------------------------


DIFF_CASES = [
    ({"jsonData": {"tokens": [[1, 2, 3, 4]]}, "meta": {"puid": "x"}},
     {"jsonData": {"tokens": [[1, 2, 3, 4]]}, "meta": {"puid": "y"}}),
    ({"jsonData": {"tokens": [[1, 2, 3, 4]]}}, {"jsonData": {"tokens": [[1, 2, 9, 4, 5]]}}),
    ({"jsonData": {"tokens": [[1, 2], [3, 4]]}}, {"jsonData": {"tokens": [[1, 2], [3, 5]]}}),
    ({"jsonData": {"tokens": [[1]]}}, {"jsonData": {"tokens": "bad"}}),
    ({"data": {"ndarray": [[1.0, 2.0]]}}, {"data": {"ndarray": [[1.0 + 1e-7, 2.0]]}}),
    ({"data": {"ndarray": [[1.0, 2.0]]}}, {"data": {"ndarray": [[1.5, 2.0]]}}),
    ({"data": {"ndarray": [[1.0, 2.0]]}}, {"data": {"ndarray": [[1.0, 2.0], [3.0, 4.0]]}}),
    ({"data": {"tensor": {"shape": [1, 2], "values": [1.0, 2.0]}}},
     {"data": {"tensor": {"shape": [1, 2], "values": [1.0, 2.001]}}}),
    ({"strData": "x"}, {"strData": "x"}),
    ({"strData": "x"}, {"strData": "y"}),
    ({}, None),
]


@pytest.mark.parametrize("a,b", DIFF_CASES, ids=[str(i) for i in range(len(DIFF_CASES))])
def test_diff_responses_agree(a, b):
    got = {pkg: json.loads(json.dumps(m(pkg, "rollout").diff_responses(a, b), default=str))
           for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert isinstance(got[PORT]["diverged"], bool)


def test_identical_generate_responses_give_zero_token_diffs():
    out = m(PORT, "rollout").diff_responses(
        {"jsonData": {"tokens": [[5, 17, 42, 9]]}}, {"jsonData": {"tokens": [[5, 17, 42, 9]]}})
    assert out == {"kind": "generate", "diverged": False, "mismatch_tokens": 0,
                   "first_mismatch": None}


# -- shadow mirror -----------------------------------------------------------


def _mirror_counts(pkg, target, n=1, **kw):
    reg = m(pkg, "graph.engine_metrics").MetricsRegistry()

    async def go():
        mirror = m(pkg, "rollout").ShadowMirror([("canary", target)], deployment="default/dep",
                                                metrics=reg, **kw)
        sent = [mirror.submit({"jsonData": {}}, {"jsonData": {"tokens": [[1, 2, 3]]}})
                for _ in range(n)]
        for _ in range(10):
            await asyncio.sleep(0.01)
        return mirror, sent

    mirror, sent = run(go())
    return (sent, dict(mirror.counts), [r["predictor"] for r in mirror.recent], mirror.inflight,
            reg.counter_total("seldon_rollout_divergence", {"predictor": "canary"}),
            reg.counter_total("seldon_rollout_mirrors"),
            reg.counter_total("seldon_rollout_mirror_errors"))


@pytest.mark.parametrize("case", ["diverged", "same", "error", "bounded"])
def test_shadow_mirror_counts_agree(case):
    async def diverged(msg):
        return {"jsonData": {"tokens": [[1, 2, 99]]}}

    async def same(msg):
        return {"jsonData": {"tokens": [[1, 2, 3]]}}

    async def boom(msg):
        raise RuntimeError("shadow died")

    target, kw = {"diverged": (diverged, {}), "same": (same, {}), "error": (boom, {}),
                  "bounded": (same, {"max_concurrency": 2})}[case]
    n = 6 if case == "bounded" else 1
    got = {pkg: _mirror_counts(pkg, target, n=n, **kw) for pkg in PKGS}
    assert got[PORT] == got[JAX]


def test_mirror_without_event_loop_drops_safely():
    got = {}
    for pkg in PKGS:
        mirror = m(pkg, "rollout").ShadowMirror([("s", lambda msg: msg)])
        got[pkg] = (mirror.submit({}, {}), dict(mirror.counts), sorted(mirror.summary()))
    assert got[PORT] == got[JAX] and got[PORT][0] == 0


# -- control-plane integration ----------------------------------------------


def _controller(pkg):
    store = m(pkg, "controlplane").ResourceStore()
    ctl = m(pkg, "controlplane").DeploymentController(
        store, runtime=m(pkg, "controlplane.runtime").InProcessRuntime(open_ports=False))
    return store, ctl


def test_canary_ramp_reroutes_without_restarting_engines():
    got = {}
    for pkg in PKGS:
        store, ctl = _controller(pkg)
        ctl.rollout = m(pkg, "rollout").RolloutController(
            store, metrics=m(pkg, "graph.engine_metrics").MetricsRegistry(), now=Clock())

        async def go():
            dep = rollout_dep(pkg, steps="25,100")
            store.apply(dep)
            await ctl.reconcile(dep.clone())
            before = dict(ctl.components)
            verdicts = ctl.rollout.tick_all()
            updated = store.get("dep")
            await ctl.reconcile(updated.clone())
            same = all(ctl.components[n][0] is before[n][0] for n in before)
            await ctl.shutdown()
            return (verdicts, {p.name: p.traffic for p in updated.predictors},
                    sorted(before), same)

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][1] == {"baseline": 75, "canary": 25} and got[PORT][3]


def test_reconciler_wires_and_clears_shadow_mirrors():
    """A shadow rollout wires a ShadowMirror on the live engine (the
    port's EngineApp.shadow_mirror), an identical graph diffs as
    non-divergent, and dropping the annotation clears the mirror."""
    got = {}
    for pkg in PKGS:
        store, ctl = _controller(pkg)

        async def go():
            dep = rollout_dep(pkg, mode="shadow")
            store.apply(dep)
            await ctl.reconcile(dep.clone())
            by_pred = {h.spec.predictor: h for h, _ in ctl.components.values()}
            mirror = by_pred["baseline"].app.shadow_mirror
            wired = (mirror is not None, by_pred["canary"].app.shadow_mirror is None,
                     [n for n, _ in mirror.targets])
            out = await by_pred["baseline"].app.predict({"data": {"ndarray": [[1.0, 2.0]]}})
            for _ in range(20):
                await asyncio.sleep(0.01)
            counts = dict(mirror.counts)
            plain = store.get("dep").clone()
            plain.predictor("canary").annotations.pop("seldon.io/rollout")
            store.apply(plain)
            await ctl.reconcile(plain.clone())
            cleared = {h.spec.predictor: h for h, _ in ctl.components.values()}[
                "baseline"].app.shadow_mirror is None
            await ctl.shutdown()
            return wired, out["data"], counts, cleared

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == (True, True, ["canary"])
    assert got[PORT][2]["mirrored"] == 1 and got[PORT][2]["diverged"] == 0 and got[PORT][3]


def test_terminal_shadow_rollout_unwires_mirror():
    got = {}
    for pkg in PKGS:
        store, ctl = _controller(pkg)
        clock = Clock()
        reg = m(pkg, "graph.engine_metrics").MetricsRegistry()
        ctl.rollout = m(pkg, "rollout").RolloutController(store, metrics=reg, now=clock)

        async def go():
            dep = rollout_dep(pkg, mode="shadow", steps="1")
            store.apply(dep)
            await ctl.reconcile(dep.clone())
            base = next(h for h, _ in ctl.components.values() if h.spec.predictor == "baseline")
            before = base.app.shadow_mirror is not None
            ctl.rollout.tick_all()
            reg.counter_inc("seldon_rollout_mirrors",
                            {"deployment": "default/dep", "predictor": "canary"}, 5)
            clock.t += 5.0
            verdicts = ctl.rollout.tick_all()
            ctl._wire_shadow_mirrors(store.get("dep"))
            after = base.app.shadow_mirror is None
            await ctl.shutdown()
            return before, verdicts, after

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][0] and got[PORT][2]
