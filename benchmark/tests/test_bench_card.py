"""On the card: each cell's control comes out not correct.

The control is the plain reference put in the program's place one
precision below the configuration's (bfloat16 -> float8 e4m3 weights),
read at the same prompts and served tokens (generate) or rows (predict)
as the program's own answers of a short window at the cell's load. For
each cell and seed: the program's reading is within the cell's limit and
the control's is past it. Each run prints one ``control`` JSON line with
both readings (``-s`` shows them).

    python -m pytest benchmark/tests/test_bench_card.py -q -m card -s
"""

import json

import pytest

from bench_cells import load_manifest
from benchmark import run as harness

M = load_manifest()
SEEDS = (3100000001, 3100000002, 3100000003)
# a short window at the cell's own load: long enough for the mix's
# longest requests to finish and for as many answers as a run compares
SECONDS = 10.0
CONTROL_KEY = {"logit_gap": "control_gap", "logit_err": "control_err"}


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_the_control_is_not_correct(card, cell, seed):
    res = harness.run_cell(M, cell, seed, SECONDS, False, control="fp8")
    (name, limit), = harness.Cell(M, cell).limits["limits"].items()
    program = res["checks"][name]["value"]
    control = res["info"][CONTROL_KEY[name]]
    print("control " + json.dumps({"cell": cell, "seed": seed, "card": card, name: program,
                                   CONTROL_KEY[name]: control, "limit": limit}))
    assert res["checks"]["failed_requests"]["value"] == 0
    assert program <= limit
    assert control > limit
