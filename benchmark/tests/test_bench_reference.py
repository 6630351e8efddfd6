"""The training cells' run on a small configuration on the CPU: the
program and the plain reference agree; the control (the reference in fp8
where the configuration says bfloat16), each planted fault of the program
and a loss that is not a number make ``correct`` false."""

from __future__ import annotations

import pytest

from conftest import TRAIN_LIMITS, Args, small_cell


def _run(cell, seed=2 ** 31 + 101):
    from harness import train
    result = train.run(cell, Args(seed), 0.0, device_name="cpu")
    result.pop("_readings")
    return result


@pytest.mark.parametrize("fm", [0, 8])
def test_program_matches_reference(tmp_path, scratch_tmpdir, fm):
    cell = small_cell(tmp_path, "train_packed", fm, file_batches=5,
                      warm_steps=1)
    result = _run(cell)
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(TRAIN_LIMITS) | {
        "nonfinite_losses"}
    for k, v in result["compared"].items():
        assert v["value"] <= TRAIN_LIMITS.get(k, 0) / 10, (k, v)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}


def _plant(monkeypatch, fault):
    """Break the program's step underneath the Trainer."""
    import torch
    from wide_deep_tpu_torch.optim import tree_get, tree_items
    from wide_deep_tpu_torch.training import loop
    step = loop.train_step

    def unchanged(model, tx, params, mstate, opt_state, batch, *a, **k):
        keep = [(t, t.detach().clone()) for _, t in tree_items(
            {"params": params, "opt": opt_state})
            if isinstance(t, torch.Tensor)]
        out = step(model, tx, params, mstate, opt_state, batch, *a, **k)
        with torch.no_grad():
            for t, v in keep:
                t.copy_(v)
        return out

    def half_batch(model, tx, params, mstate, opt_state, batch, *a, **k):
        batch = dict(batch)
        mask = batch["mask"].clone()
        mask[mask.shape[0] // 2:] = 0
        batch["mask"] = mask
        return step(model, tx, params, mstate, opt_state, batch, *a, **k)

    def slots_unchanged(model, tx, params, mstate, opt_state, batch,
                        sparse_tables, *a, **k):
        """Params updated, every optimizer slot (FTRL's n and z, Adagrad's
        accumulators, the fused table's slot columns) put back."""
        keep = [(t, t.detach().clone()) for _, t in tree_items(opt_state)
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
        fused = []
        for t in sparse_tables.values():
            w = tree_get(params, t.path)
            fused.append((w, w[:, t.dim:].detach().clone(), t.dim))
        out = step(model, tx, params, mstate, opt_state, batch,
                   sparse_tables, *a, **k)
        with torch.no_grad():
            for t, v in keep:
                t.copy_(v)
            for w, v, dim in fused:
                w[:, dim:] = v
        return out

    def nan_loss(model, tx, params, mstate, opt_state, batch, *a, **k):
        """Sound steps, but every loss past the probed and warm-up steps
        (3 + 1) reads NaN."""
        out = step(model, tx, params, mstate, opt_state, batch, *a, **k)
        calls.append(1)
        if len(calls) > 4:
            return (out[0], torch.full_like(out[1], float("nan"))) + tuple(
                out[2:])
        return out

    calls = []
    monkeypatch.setattr(loop, "train_step",
                        {"unchanged": unchanged, "half": half_batch,
                         "slots_unchanged": slots_unchanged,
                         "nan_loss": nan_loss}[fault])


@pytest.mark.parametrize("fault,caught_by", [
    ("unchanged", "change_gap"), ("half", "loss_gap"),
    ("slots_unchanged", "slot_gap"), ("nan_loss", "nonfinite_losses")])
@pytest.mark.parametrize("fm", [0, 8])
def test_planted_fault_is_not_correct(tmp_path, scratch_tmpdir, monkeypatch,
                                      fault, caught_by, fm):
    cell = small_cell(tmp_path, "train_packed", fm, file_batches=5,
                      warm_steps=1)
    _plant(monkeypatch, fault)
    result = _run(cell)
    assert not result["correct"], result["compared"]
    got = result["compared"][caught_by]
    assert got["value"] > got["limit"], result["compared"]


def test_control_is_not_correct(tmp_path, scratch_tmpdir):
    """The reference in fp8 where the configuration says bfloat16 (the
    small configuration's dense layers), put in the program's place."""
    import torch
    from harness import judge, train
    from harness.weights import Weights
    cell = small_cell(tmp_path, "train_packed", 0, file_batches=4)
    setup = train.Setup(cell, 11)
    weights = Weights(setup.ref_model.leaf_specs(), 11, torch.device("cpu"))
    batches = train.parse_batches(setup, train.probed_lines(setup))
    ref = train.reference_readings(setup, weights, batches, "cpu")
    lowp = train.reference_readings(setup, weights, batches, "cpu",
                                    lowp=True)
    numbers = judge.training_numbers(lowp, ref)
    assert not judge.verdict(numbers, TRAIN_LIMITS), numbers
    setup.cleanup()
