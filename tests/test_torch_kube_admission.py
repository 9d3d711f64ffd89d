"""Admission of SeldonDeployment CRs in the port's operator
(seldon_core_tpu_torch/controlplane/kube.py) held against the JAX
package's on the CPU.

Counterpart of tests/test_kube_admission.py: the CRD manifest (schema and
CEL rules) equals the JAX package's, and ``validate_cr`` — the schema's
and the rules' Python twins — admits or rejects every fixture as the JAX
package does, with the same message; a fake apiserver that validates on
write keeps an invalid CR out. With cel-python installed (the JAX test's
own condition) every rule compiles and agrees with its twin."""

import copy

import pytest

from _torch_tools import JAX, PKGS, PORT, fake_kube, m

CR_PATH = "/apis/machinelearning.seldon.io/v1/namespaces/default/seldondeployments"


def kube(pkg):
    return m(pkg, "controlplane.kube")


def good_cr(name="m"):
    return {
        "apiVersion": "machinelearning.seldon.io/v1",
        "kind": "SeldonDeployment",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"name": name, "predictors": [{
            "name": "default", "replicas": 1,
            "graph": {"name": "clf", "type": "MODEL", "implementation": "SKLEARN_SERVER",
                      "modelUri": "file:///models/iris"}}]},
    }


def _two(cr, t0, t1, same_name=False):
    p2 = copy.deepcopy(cr["spec"]["predictors"][0])
    if not same_name:
        p2["name"] = "canary"
    cr["spec"]["predictors"].append(p2)
    cr["spec"]["predictors"][0]["traffic"] = t0
    cr["spec"]["predictors"][1]["traffic"] = t1
    return cr


def fixtures():
    """name -> CR: the JAX tests' fixtures and a few more edges."""
    out = {"good": good_cr()}
    cr = good_cr()
    cr["spec"]["predictors"] = []
    out["no-predictors"] = cr
    out["duplicate-names"] = _two(good_cr(), 50, 50, same_name=True)
    out["traffic-70"] = _two(good_cr(), 50, 20)
    out["traffic-100"] = _two(good_cr(), 50, 50)
    cr = good_cr()
    cr["spec"]["predictors"][0]["traffic"] = 37
    out["single-traffic-37"] = cr
    cr = good_cr()
    del cr["spec"]["predictors"][0]["graph"]["modelUri"]
    out["no-model-uri"] = cr
    cr = good_cr()
    cr["spec"]["predictors"][0]["graph"]["type"] = "NOT_A_TYPE"
    out["bad-type"] = cr
    cr = good_cr()
    cr["spec"]["predictors"][0]["traffic"] = 250
    out["traffic-250"] = cr
    cr = good_cr()
    cr["spec"]["predictors"][0]["replicas"] = -1
    out["negative-replicas"] = cr
    cr = good_cr()
    cr["spec"]["predictors"][0]["replicas"] = True
    out["bool-replicas"] = cr
    cr = good_cr()
    del cr["spec"]["predictors"][0]["graph"]
    out["no-graph"] = cr
    cr = good_cr()
    cr["spec"]["predictors"][0]["graph"]["children"] = [{"name": ""}]
    out["empty-child-name"] = cr
    cr = good_cr()
    cr["spec"]["predictors"] = {"a": 1}
    out["predictors-not-a-list"] = cr
    cr = good_cr()
    del cr["spec"]
    out["no-spec"] = cr
    cr = good_cr()
    cr["spec"]["predictors"][0]["graph"]["implementation"] = "JAX_SERVER"
    del cr["spec"]["predictors"][0]["graph"]["modelUri"]
    out["jax-server-no-uri"] = cr
    return out


FIXTURES = fixtures()


def _verdict(pkg, cr):
    try:
        kube(pkg).validate_cr(copy.deepcopy(cr))
        return None
    except kube(pkg).KubeApiError as e:
        return (e.status, str(e))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_validate_cr_equals_jax_on_every_fixture(name):
    want, got = (_verdict(pkg, FIXTURES[name]) for pkg in PKGS)
    assert got == want
    # the schema does not require ``spec`` itself (the JAX CRD's choice)
    assert (got is None) == (name in ("good", "traffic-100", "no-spec"))


def test_crd_manifest_and_rules_equal_jax():
    assert kube(PORT).CRD_MANIFEST == kube(JAX).CRD_MANIFEST
    assert kube(PORT).CEL_RULES == kube(JAX).CEL_RULES
    assert kube(PORT).PREPACKAGED_IMPLEMENTATIONS == kube(JAX).PREPACKAGED_IMPLEMENTATIONS
    assert (kube(PORT).GROUP, kube(PORT).VERSION, kube(PORT).PLURAL, kube(PORT).MANAGED_BY) == (
        kube(JAX).GROUP, kube(JAX).VERSION, kube(JAX).PLURAL, kube(JAX).MANAGED_BY)
    spec_schema = kube(PORT).CRD_MANIFEST["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]
    assert spec_schema["x-kubernetes-validations"] == kube(PORT).CEL_RULES
    assert len(kube(PORT).CEL_RULES) == len(kube(PORT)._CEL_TWINS)


# the twins run only on a spec with a predictor list (as in validate_cr)
TWIN_FIXTURES = sorted(n for n, cr in FIXTURES.items()
                       if isinstance(cr.get("spec", {}).get("predictors"), list))


@pytest.mark.parametrize("name", TWIN_FIXTURES)
def test_cel_twins_equal_jax(name):
    spec = FIXTURES[name]["spec"]
    for a, b in zip(kube(JAX)._CEL_TWINS, kube(PORT)._CEL_TWINS):
        assert b(copy.deepcopy(spec)) == a(copy.deepcopy(spec))


def _admitting_fake():
    fake = fake_kube(PORT)
    create, replace = fake.create, fake.replace

    def checked_create(path, obj):
        if "seldondeployments" in path:
            kube(PORT).validate_cr(obj)
        return create(path, obj)

    def checked_replace(path, obj):
        if "seldondeployments" in path and not path.endswith("/status"):
            kube(PORT).validate_cr(obj)
        return replace(path, obj)

    fake.create, fake.replace = checked_create, checked_replace
    return fake


def test_invalid_cr_never_reaches_the_store_and_update_keeps_the_original():
    api = _admitting_fake()
    with pytest.raises(kube(PORT).KubeApiError) as e:
        api.create(CR_PATH, FIXTURES["no-predictors"])
    assert e.value.status == 422 and not api.objects
    stored = api.create(CR_PATH, good_cr())
    bad = copy.deepcopy(stored)
    bad["spec"]["predictors"] = []
    with pytest.raises(kube(PORT).KubeApiError):
        api.replace(f"{CR_PATH}/m", bad)
    assert api.objects[f"{CR_PATH}/m"]["spec"]["predictors"]


try:
    import celpy
except ImportError:  # optional dev dependency, as in tests/test_kube_admission.py
    celpy = None

requires_cel = pytest.mark.skipif(celpy is None, reason="cel-python not installed")


def _cel_programs():
    env = celpy.Environment()
    out = []
    for rule in kube(PORT).CEL_RULES:
        ast = env.compile(rule["rule"])
        out.append((rule, env.program(ast, functions={
            "sum": lambda items: sum((int(i) for i in items), 0)})))
    return out


@requires_cel
def test_cel_rules_compile_under_real_evaluator():
    assert len(_cel_programs()) == len(kube(PORT).CEL_RULES)


@requires_cel
def test_cel_rules_evaluate_fixtures_like_twins():
    specs = [FIXTURES[n]["spec"] for n in ("good", "duplicate-names", "traffic-70",
                                             "single-traffic-37", "no-model-uri")]
    unsupported = []
    for (rule, prgm), twin in zip(_cel_programs(), kube(PORT)._CEL_TWINS):
        for spec in specs:
            activation = {"self": celpy.json_to_cel({"predictors": spec.get("predictors", [])})}
            try:
                got = bool(prgm.evaluate(activation))
            except celpy.CELEvalError as e:
                unsupported.append((rule["message"], str(e)[:80]))
                break
            assert got == bool(twin(spec)), rule["message"]
    assert len(unsupported) <= 1, unsupported
