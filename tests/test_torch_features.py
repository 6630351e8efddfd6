"""Parity of the port's host side with the JAX package's: config, hashing,
FeaturePlan layout and the packed batches (with their kernel plans).

Also the shared helpers of the tests/test_torch_*.py files: a small config
whose plan carries every kind of kernel plan, the patches that force the
plans at test batch sizes in BOTH packages, and tree comparisons.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import REPO, TRAIN1  # noqa: E402

# d4 (17,408 rows) stays folded; d8 (123,136 rows) unfolds and, with
# SPARSE_MIN_ROWS forced to 1, takes the fused sparse optimizer — so one
# small config carries a folded kernel-planned group AND a sopt_* group,
# like the production d8/d32 pair
FOLD_MAX_ROWS = 20000


def write_conf(dst, bf16: bool = False) -> str:
    """Small conf (hash spaces capped, [32, 16] towers) with the fold cap
    above; ``bf16``: the production embedding/dense dtypes."""
    from wide_deep_tpu_torch.testing import write_small_conf
    write_small_conf(str(dst))
    path = os.path.join(str(dst), "model.yaml")
    with open(path) as f:
        text = f.read()
    text = text.replace("embedding_dtype: float32",
                        f"embedding_dtype: {'bfloat16' if bf16 else 'float32'}")
    text = text.replace("dense_dtype: bfloat16",
                        f"dense_dtype: {'bfloat16' if bf16 else 'float32'}")
    with open(path, "w") as f:
        f.write(text + f"\nwide_fold_max_rows: {FOLD_MAX_ROWS}\n")
    return str(dst)


def force_plans(monkeypatch, mode: str):
    """Force kernel plans at test batch sizes in both packages, the way
    tests/test_scatter_kernel.py and tests/test_sparse_optim.py force them:
    ``mode`` 'range' gives folded groups scat_* plans, 'window' wscat_*;
    unfolded groups take the fused sparse optimizer (sopt_*)."""
    import wide_deep_tpu.features.plan as jplan
    import wide_deep_tpu.optim.sparse as jsparse
    import wide_deep_tpu_torch.features.plan as tplan
    import wide_deep_tpu_torch.optim.sparse as tsparse
    want_range = mode == "range"
    for plan_mod, sparse_mod in ((jplan, jsparse), (tplan, tsparse)):
        monkeypatch.setattr(sparse_mod, "SPARSE_MIN_ROWS", 1)
        monkeypatch.setattr(
            plan_mod.FeaturePlan, "scatter_group",
            lambda self, g, b, _r=want_range: (
                _r and self.pallas_scatter and g.folded))
        monkeypatch.setattr(
            plan_mod.FeaturePlan, "window_group",
            lambda self, g, b, _r=want_range: (
                not _r and self.pallas_scatter and g.folded))


def train_rows(n: int, start: int = 0):
    with open(TRAIN1) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    return [line.split("\t") for line in lines[start:start + n]]


def plan_pair(conf_dir, **kw):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.plan import FeaturePlan as JPlan
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.plan import FeaturePlan as TPlan
    return (JPlan(JConfig(conf_dir), **kw), TPlan(TConfig(conf_dir), **kw))


def batch_pair(jplan, tplan, rows, batch_size):
    """The same rows through both packages' transformers; asserts the
    batches are identical and returns the numpy batch."""
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    jb = JT(jplan).transform(rows, batch_size, mode="train")
    tb = TT(tplan).transform(rows, batch_size, mode="train")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    return tb


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def leaves(tree, prefix=()):
    """{path: leaf} of a nested dict/list tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, prefix + (i,)))
    else:
        out[prefix] = tree
    return out


def as_f64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float64)


def assert_trees_close(jtree, ttree, rtol, atol, what=""):
    jl, tl = leaves(jtree), leaves(ttree)
    assert sorted(map(str, jl)) == sorted(map(str, tl)), what
    for path, jv in jl.items():
        np.testing.assert_allclose(as_f64(tl[path]), as_f64(jv), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {path}")


def jax_init(model, batch_np, sparse_tables=None):
    """JAX params + BN state (numpy), fused slots initialised."""
    import jax.numpy as jnp
    from wide_deep_tpu.optim.sparse import init_fused_params
    params, mstate = model.init(jax.random.PRNGKey(0),
                                {k: jnp.asarray(v)
                                 for k, v in batch_np.items()})
    params = init_fused_params(params, sparse_tables or {})
    return jax.device_get(params), jax.device_get(mstate)


# --------------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def conf_dir(tmp_path_factory):
    return write_conf(tmp_path_factory.mktemp("torch_conf"))


def test_config_parity(conf_dir):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu_torch.config import Config as TConfig
    for d in (conf_dir, os.path.join(REPO, "conf")):
        j, t = JConfig(d), TConfig(d)
        assert j.model == t.model
        assert j.train == t.train
        assert j.read_feature_conf() == t.read_feature_conf()
        assert j.read_cross_feature_conf() == t.read_cross_feature_conf()
        assert j.runconfig == t.runconfig


def test_hashing_parity():
    from wide_deep_tpu.features import hashing as jh
    from wide_deep_tpu_torch.features import hashing as th
    rng = np.random.default_rng(0)
    for n in (0, 3, 8, 31, 32, 33, 100):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert jh.fingerprint64(data) == th.fingerprint64(data)
    cols = [rng.integers(0, 2 ** 63, 50, dtype=np.uint64) for _ in range(3)]
    np.testing.assert_array_equal(jh.cross_fingerprint_np(cols),
                                  th.cross_fingerprint_np(cols))


@pytest.mark.parametrize("which", ["small", "production"])
@pytest.mark.parametrize("kw", [
    {}, {"pallas_scatter": True, "sparse_opt": True},
    {"fold": False, "sparse_opt": True}, {"pack_budget": 5}])
def test_plan_layout_parity(conf_dir, which, kw):
    d = conf_dir if which == "small" else os.path.join(REPO, "conf")
    jp, tp = plan_pair(d, **kw)
    assert jp.to_dict() == tp.to_dict()
    assert jp.describe() == tp.describe()
    np.testing.assert_array_equal(jp.indicator_wide_rows,
                                  tp.indicator_wide_rows)
    for B in (16, 25600):
        assert jp.batch_spec(B) == tp.batch_spec(B)
        for g in jp.groups:
            for fn in ("scatter_group", "window_group", "sparse_opt_group"):
                assert getattr(jp, fn)(g, B) == getattr(tp, fn)(g, B), fn


@pytest.mark.parametrize("mode", ["range", "window"])
def test_transformer_parity_with_plans(conf_dir, monkeypatch, mode):
    force_plans(monkeypatch, mode)
    jp, tp = plan_pair(conf_dir, pallas_scatter=True, sparse_opt=True)
    batch = batch_pair(jp, tp, train_rows(40), 48)   # 8 padding rows
    prefix = "scat_" if mode == "range" else "wscat_"
    assert any(k.startswith(prefix) for k in batch), sorted(batch)
    assert any(k.startswith("sopt_") for k in batch), sorted(batch)
    assert batch["mask"].sum() == 40


def test_pack_budget_auto_parity(conf_dir):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.analyze import resolve_pack_budget as jr
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.analyze import resolve_pack_budget as tr
    assert (jr(JConfig(conf_dir), TRAIN1, raw="auto")
            == tr(TConfig(conf_dir), TRAIN1, raw="auto"))


def test_csv_dataset_parity(conf_dir):
    """Same file, seed and shuffle buffer: identical batch stream from the
    Python loaders (tests/test_torch_native.py holds the native paths)."""
    from wide_deep_tpu.features.pipeline import CsvDataset as JD
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu_torch.features.pipeline import CsvDataset as TD
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    jp, tp = plan_pair(conf_dir)
    jds = JD(jp, TRAIN1, "train", 64, shuffle_buffer=100, seed=5,
             transformer=JT(jp))
    tds = TD(tp, TRAIN1, "train", 64, shuffle_buffer=100, seed=5,
             transformer=TT(tp))
    for i, (jb, tb) in enumerate(zip(jds, tds)):
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
        if i == 2:
            break
