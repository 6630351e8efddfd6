"""Training across ranks: the port's Trainer on 2 gloo ranks (tests/
torch_rank_cases.py) against the JAX package's Trainer on a 2-device mesh
(tests/test_distributed.py's concerns, in one process for JAX).

Both start from the JAX Trainer's initial weights, read the same global
batches (the port's ranks through the input service, or on a mesh whose
'data' axis is 1 each the whole batch) with per-shard range plans on the
folded group and the sharded fused optimizer on the unfolded one, float32
model.  Each step's loss must lie within 1e-5 of JAX's and be the same
bits on both ranks.  Uneven row shards must agree on their batch count and
give one device's metrics.  A checkpoint moves N -> 1 and 1 -> N bit for
bit.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import force_plans, write_conf  # noqa: E402
from torch_rank_cases import run_ranks  # noqa: E402

B = 16
STEPS = 3


def _conf(dst, service=None, lookup="explicit"):
    d = write_conf(dst)
    p = os.path.join(d, "train.yaml")
    with open(p) as f:
        text = f.read()
    text = text.replace("sharded_lookup: gspmd", f"sharded_lookup: {lookup}")
    if service:
        text = text.replace('input_service: ""',
                            f'input_service: "{service}"')
    with open(p, "w") as f:
        f.write(text)
    return d


def _data(path, n, start=0):
    with open(TRAIN1) as f, open(path, "w") as out:
        for i, line in enumerate(f):
            if start <= i < start + n:
                out.write(line)
    return str(path)


def _overrides(data, batch=B):
    return dict(train_data=data, eval_data=data, test_data=data,
                keep_train=True, batch_size=batch, pack_budget=3,
                sparse_optimizer=True, scatter_mode="pallas",
                shard_threshold=1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX run, the port's ranks (with and without the input service,
    uneven shards, and a restore), and a one-device port run, all once."""
    mp = pytest.MonkeyPatch()
    try:
        yield _run_all(tmp_path_factory.mktemp("distributed"), mp)
    finally:
        mp.undo()


def _run_all(tmp, mp):
    import argparse
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.parallel import mesh as jmesh
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.tools.input_server import build_server
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer

    force_plans(mp, "range")
    out = {}
    conf = _conf(tmp / "conf")
    data = _data(tmp / "train", STEPS * B)
    ov = _overrides(data)

    # JAX on a 2-device mesh
    jtr = JTrainer(JConfig(conf), model_type="wide_deep",
                   model_dir=str(tmp / "jax"), overrides=ov,
                   mesh=jmesh.make_mesh(2, 1, jax.devices()[:2]))
    jtr.ensure_initialized(restore=False)
    params, mstate = from_jax(jax.device_get(jtr.params),
                              jax.device_get(jtr.mstate), device="cpu")
    jlosses, step = [], jtr._train_step

    def record(*a):
        r = step(*a)
        jlosses.append(float(r[3]))
        return r
    jtr._train_step = record
    jtr.train_file(data)
    out["jax_losses"] = jlosses
    out["jax_eval"] = jtr.evaluate(data)
    out["jax_plan_keys"] = sorted(jtr.plan.batch_spec(B))

    # the input service, serving the ranks' plan
    cfg = TConfig(conf)
    tc = dict(cfg.train, **ov)
    srv, _ = build_server(cfg, tc, argparse.Namespace(
        model_type="wide_deep", n_devices=2, n_procs=2, n_classes=2,
        batch_size=B, port=0, proc_start=0, proc_count=None,
        image_train_data=None))
    srv.start()
    try:
        conf_svc = _conf(tmp / "conf_svc", f"127.0.0.1:{srv.port}")
        base = dict(force_plans="range", overrides=ov, data=data,
                    eval_data=data, params=params, mstate=mstate)
        out["svc"] = run_ranks("trainer", 2, tmp, dict(
            base, mesh=(2, 1), conf_dir=conf_svc,
            model_dir=str(tmp / "ranks_svc"), save=True))
    finally:
        srv.stop()
    out["model_axis"] = run_ranks("trainer", 2, tmp, dict(
        base, mesh=(1, 2), conf_dir=conf, model_dir=str(tmp / "ranks_1x2")))

    # uneven row shards: 9 rows over 2 ranks at 4 rows a rank
    odd = _data(tmp / "odd", 9, start=100)
    out["uneven"] = run_ranks("trainer", 2, tmp, dict(
        base, mesh=(2, 1), conf_dir=conf, model_dir=str(tmp / "ranks_odd"),
        overrides=_overrides(odd, 8), data=odd, eval_data=odd,
        params=None))
    out["odd"] = odd

    # one device: the same weights and batches, then a checkpoint
    one = TTrainer(TConfig(conf), model_type="wide_deep",
                   model_dir=str(tmp / "one"), overrides=ov, device="cpu")
    one.params, one.mstate = params, mstate
    one.ensure_initialized(restore=False)
    one.train_file(data)
    one.save()
    out["one_losses"] = [float(x) for x in one.losses]
    out["one"] = one
    out["restored"] = run_ranks("trainer", 2, tmp, dict(
        mesh=(1, 2), conf_dir=conf, model_dir=str(tmp / "one"),
        overrides=ov, data=data, train=False, restore=True,
        force_plans="range"))
    # sharded_lookup: gspmd: JAX leaves the gathers to GSPMD (no kernel
    # plans, no fused table); the port runs its exchange without plans
    conf_g = _conf(tmp / "conf_gspmd", lookup="gspmd")
    jg = JTrainer(JConfig(conf_g), model_type="wide_deep",
                  model_dir=str(tmp / "jax_gspmd"), overrides=ov,
                  mesh=jmesh.make_mesh(2, 1, jax.devices()[:2]))
    jg.ensure_initialized(restore=False)
    gparams, gmstate = from_jax(jax.device_get(jg.params),
                                jax.device_get(jg.mstate), device="cpu")
    glosses, gstep = [], jg._train_step

    def grecord(*a):
        r = gstep(*a)
        glosses.append(float(r[3]))
        return r
    jg._train_step = grecord
    jg.train_file(data)
    out["gspmd_jax"] = glosses
    out["gspmd"] = run_ranks("trainer", 2, tmp, dict(
        mesh=(1, 2), conf_dir=conf_g, model_dir=str(tmp / "ranks_gspmd"),
        overrides=ov, data=data, params=gparams, mstate=gmstate,
        force_plans="range"))
    out["conf"], out["ov"], out["tmp"] = conf, ov, tmp
    out["ranks_svc_dir"] = str(tmp / "ranks_svc")
    return out


@pytest.mark.parametrize("run", ["svc", "model_axis"])
def test_losses_match_jax_and_ranks_agree(world, run):
    r0, r1 = world[run]
    assert r0["losses"] == r1["losses"]               # bit for bit
    assert len(r0["losses"]) == STEPS
    np.testing.assert_allclose(r0["losses"], world["jax_losses"], rtol=1e-5)
    assert r0["paths"] == r1["paths"] and ("linear", "w") in r0["paths"]
    # the ranks trained on per-shard plans: range plan rows and the
    # sharded fused optimizer's
    assert any(k.startswith("scat_ok_") for k in r0["plan_keys"])
    assert any(k.startswith("sopt_ok_") for k in r0["plan_keys"])


@pytest.mark.parametrize("run", ["svc", "model_axis"])
def test_evaluate_gives_one_devices_metrics(world, run):
    r0, r1 = world[run]
    assert r0["eval"] == r1["eval"]
    for k in ("auc", "loss", "accuracy"):
        np.testing.assert_allclose(r0["eval"][k], world["jax_eval"][k],
                                   rtol=1e-5, err_msg=k)


def test_one_device_port_matches_ranks(world):
    np.testing.assert_allclose(world["svc"][0]["losses"],
                               world["one_losses"], rtol=1e-5)


def test_uneven_shards_sync_batch_counts(world):
    """5 rows and 4 rows at 4 a rank: rank 1 feeds a zero-weight batch
    while rank 0 trains its second; both agree on every loss, and their
    evaluation is one device's over the same params."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    r0, r1 = world["uneven"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert r0["eval"] == r1["eval"]
    # without the input service a 'data' axis of 2 has no kernel plans and
    # so no fused tables (the JAX package's topology gate): nor here
    one = Trainer(Config(world["conf"]), model_type="wide_deep",
                  model_dir=str(world["tmp"] / "odd_one"),
                  overrides=dict(_overrides(world["odd"], 8),
                                 sparse_optimizer=False), device="cpu")
    one.ensure_initialized(restore=False)
    _load_whole(one, r0["state"])
    res = one.evaluate(world["odd"])
    for k in ("auc", "loss", "accuracy"):
        np.testing.assert_allclose(r0["eval"][k], res[k], rtol=1e-6,
                                   err_msg=k)


def _load_whole(trainer, state):
    from wide_deep_tpu_torch.training.checkpoint import named_leaves
    tree = {"params": trainer.params, "mstate": trainer.mstate,
            "opt_state": trainer.opt_state}
    for name, leaf in named_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(state[name])


def _state(trainer):
    from wide_deep_tpu_torch.training.checkpoint import named_leaves
    return {n: t.detach().clone() for n, t in named_leaves(
        {"params": trainer.params, "mstate": trainer.mstate,
         "opt_state": trainer.opt_state}) if isinstance(t, torch.Tensor)}


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_n_to_1(world):
    """The ranks' checkpoint is the file set one device writes: a one-device
    Trainer restores it to the ranks' whole state, bit for bit."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    d = str(world["tmp"] / "n_to_1")
    shutil.copytree(world["ranks_svc_dir"], d)
    one = Trainer(Config(world["conf"]), model_type="wide_deep",
                  model_dir=d, overrides=world["ov"], device="cpu")
    one.ensure_initialized(restore=True)
    assert one.global_step == STEPS
    _assert_states_equal(_state(one), world["svc"][0]["state"])


def test_checkpoint_1_to_n(world):
    """One device's checkpoint restores into the ranks: each takes its rows,
    and their whole state is the one device's, bit for bit."""
    r0, r1 = world["restored"]
    assert r0["step0"] == r1["step0"] == STEPS
    _assert_states_equal(r0["state"], _state(world["one"]))


def test_gspmd_lookup_runs_the_exchange_without_plans(world):
    """sharded_lookup: gspmd, where JAX lets GSPMD derive the collectives:
    the port has no GSPMD and runs its explicit exchange without kernel
    plans (a difference on purpose, ROADMAP.md Queue 3); the losses are
    JAX's within 1e-5 and the same bits on both ranks."""
    r0, r1 = world["gspmd"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == STEPS
    np.testing.assert_allclose(r0["losses"], world["gspmd_jax"], rtol=1e-5)
    assert not any(k.startswith(("scat_", "wscat_", "sopt_"))
                   for k in r0["plan_keys"])
    assert ("linear", "w") in r0["paths"]
