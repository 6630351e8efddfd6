"""The port's collective budget (wide_deep_tpu_torch/tools/
collective_budget.py, parallel/collective_stats.py): the counterpart of
tests/test_collective_budget.py.

The committed ``collective_budget_torch.json`` holds the production step's
bytes and calls a rank by tag on the mesh ``{data: 4, model: 2}``, for the
explicit and the dedup exchange; ``check`` must pass on it and fail when a
tag grows by more than 15%, when a tag appears and when one vanishes.
That the prediction equals what the ranks count is held in
tests/test_torch_dedup.py (on the CPU) and in chip_smoke.py phase 11 (on
the card).
"""

import copy
import json
import os

import pytest

pytest.importorskip("torch")

from paths import REPO  # noqa: E402

BUDGET = os.path.join(REPO, "collective_budget_torch.json")


@pytest.fixture(scope="module")
def predicted():
    from wide_deep_tpu_torch.tools.collective_budget import predict
    return predict()


@pytest.fixture(scope="module")
def budget():
    with open(BUDGET) as f:
        return json.load(f)


def test_budget_file_is_committed(budget):
    for key in ("mesh", "batch_size", "lookups", "tolerance",
                "assumptions"):
        assert key in budget, key
    assert budget["mesh"] == {"data": 4, "model": 2}
    assert budget["tolerance"] == 1.15
    assert sorted(budget["lookups"]) == ["dedup", "explicit"]
    for lookup, e in budget["lookups"].items():
        assert e["per_tag"] and e["total_bytes"] == sum(
            t["bytes"] for t in e["per_tag"].values())
    assert "dedup_rows" in budget["lookups"]["dedup"]["per_tag"]
    assert "dedup_rows" not in budget["lookups"]["explicit"]["per_tag"]
    assert "time_model" in budget["assumptions"]


def test_check_passes_on_committed_budget(budget, predicted):
    from wide_deep_tpu_torch.tools.collective_budget import compare
    assert compare(budget, predicted) == []


def _scaled(budget, lookup, tag, factor):
    b = copy.deepcopy(budget)
    e = b["lookups"][lookup]["per_tag"][tag]
    e["bytes"] = int(e["bytes"] / factor)
    return b


@pytest.mark.parametrize("lookup,tag", [("explicit", "lookup"),
                                        ("dedup", "dedup_rows_bwd"),
                                        ("dedup", "grads")])
def test_check_fails_past_tolerance(budget, predicted, lookup, tag):
    """A tag 16% above its budget fails; 14% above passes."""
    from wide_deep_tpu_torch.tools.collective_budget import compare
    assert compare(_scaled(budget, lookup, tag, 1.14), predicted) == []
    problems = compare(_scaled(budget, lookup, tag, 1.16), predicted)
    assert len(problems) == 1 and tag in problems[0], problems


@pytest.mark.parametrize("fault", ["new_tag", "missing_tag", "calls"])
def test_check_fails_on_tag_changes(budget, predicted, fault):
    from wide_deep_tpu_torch.tools.collective_budget import compare
    b = copy.deepcopy(budget)
    tags = b["lookups"]["dedup"]["per_tag"]
    if fault == "new_tag":
        del tags["dedup_rows"]           # the step has a tag it lacks
        want = "new collective tag dedup_rows"
    elif fault == "missing_tag":
        tags["halo"] = {"bytes": 1, "calls": 1}
        want = "budgeted tag halo missing"
    else:
        tags["bn"]["calls"] = 2
        want = "bn: 6 calls exceed 2x budget 2"
    problems = compare(b, predicted)
    assert len(problems) == 1 and want in problems[0], problems


def test_cli_capture_then_check(tmp_path, budget):
    """capture writes the committed file's numbers; check exits 0 on it
    and 1 on a budget 16% short."""
    from wide_deep_tpu_torch.tools.collective_budget import main
    path = str(tmp_path / "budget.json")
    assert main(["capture", "--path", path]) == 0
    with open(path) as f:
        got = json.load(f)
    assert got["lookups"] == budget["lookups"]
    assert main(["check", "--path", path]) == 0
    with open(path, "w") as f:
        json.dump(_scaled(got, "explicit", "lookup_bwd", 1.16), f)
    assert main(["check", "--path", path]) == 1


@pytest.mark.parametrize("mesh,want", [((2, 1), 46780416),
                                       ((1, 2), 31390200)])
def test_production_prediction_equals_the_cards_count(mesh, want):
    """The production step's explicit exchange on the two 2-rank meshes
    that chip_smoke.py phase 11 runs: the prediction is the byte count the
    card's ranks gave (46,780,416 and 31,390,200 a rank a step, PERF.md),
    tag by tag where PERF.md lists them."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.parallel.collective_stats import step_collectives
    c = Config(os.path.join(REPO, "conf"))
    s = step_collectives(c, dict(c.train, pack_budget=3, batch_size=25600),
                         *mesh, global_batch_input=True, lookup="explicit")
    assert s["total_bytes"] == want
    if mesh == (2, 1):
        assert s["by_tag"] == {
            "lookup": 28110316, "lookup_bwd": 11163116, "grads": 5788680,
            "sparse_update": 1689600, "bn": 14348, "bn_bwd": 14348,
            "loss": 8}
