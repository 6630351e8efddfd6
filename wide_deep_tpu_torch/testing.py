"""Test and smoke-run helpers: scaled-down configs, a schema-conformant TSV
generator and synthetic production batches (the port's copies of
wide_deep_tpu/testing.py and bench.py's synthetic_batch)."""

from __future__ import annotations

import os
import re
import shutil
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_small_conf(dst_dir: str,
                     hash_cap: int = 1000,
                     cross_cap_k: int = 5,
                     hidden_units: str = "[32, 16]",
                     batch_size: int = 16,
                     num_examples: int = 100) -> str:
    """Copy conf/ into ``dst_dir`` with shrunken table sizes; returns path."""
    src = os.path.join(REPO_ROOT, "conf")
    os.makedirs(dst_dir, exist_ok=True)
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name), os.path.join(dst_dir, name))

    def rewrite(name, fn):
        path = os.path.join(dst_dir, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(fn(text))

    rewrite("feature.yaml", lambda t: re.sub(
        r"parameter: (\d{4,})\b", f"parameter: {hash_cap}", t))
    rewrite("cross_feature.yaml", lambda t: re.sub(
        r"hash_bucket_size: (\d+)",
        lambda m: f"hash_bucket_size: {min(int(m.group(1)), cross_cap_k)}", t))
    rewrite("model.yaml", lambda t: t.replace(
        "dnn_hidden_units: [1024, 512, 256]",
        f"dnn_hidden_units: {hidden_units}").replace(
        "embedding_dtype: bfloat16", "embedding_dtype: float32"))
    rewrite("train.yaml", lambda t: t.replace(
        "batch_size: 64", f"batch_size: {batch_size}").replace(
        "num_examples: 10000", f"num_examples: {num_examples}").replace(
        # pinned budget: tests need stable pool layouts regardless of which
        # fixture a Trainer points at (auto sizes from the data)
        "pack_budget: auto", "pack_budget: 3").replace(
        # pinned lookup: the default `auto` resolves to the explicit
        # exchange on the virtual 8-device test mesh, which would silently
        # reroute every default-Trainer test; exchange tests opt in
        "sharded_lookup: auto", "sharded_lookup: gspmd"))
    return dst_dir


def small_config(dst_dir: str | None = None, **kwargs):
    from wide_deep_tpu_torch.config import Config
    if dst_dir is None:
        dst_dir = tempfile.mkdtemp(prefix="wdt_conf_")
    return Config(write_small_conf(dst_dir, **kwargs))


def generate_ctr_tsv(config, path: str, n: int, seed: int,
                     pos_rate: float = 0.08, n_classes: int = 2,
                     hash_spread: int | None = 5000) -> float:
    """Vectorized schema-conformant TSV generator (planted
    hour/site/age/gender signal re-centered to ``pos_rate``, zipf-skewed
    hash ids, 3% missing markers).  Shared by tools/quality_matrix.py and
    bench.py's end-to-end stage — the e2e benchmark needs DIVERSE rows:
    replicating the 2000-row sample 350x produced a degenerate id
    distribution whose batches tripped the scatter kernels' data-dependent
    fallback branches, measuring the fallback instead of the production
    path.  Returns the achieved positive rate (binary) / mid-class share
    (multiclass)."""
    import numpy as np
    schema = config.schema_columns()
    feature_conf = config.read_feature_conf()
    rng = np.random.default_rng(seed)

    cols = {}
    for name in schema[1:]:
        conf = feature_conf.get(name)
        if conf is None:
            pool = np.array([f"x{i}" for i in range(1000)])
            cols[name] = pool[rng.integers(0, len(pool), n)]
        elif conf["type"] == "continuous":
            a, b = conf["parameter"].get("normalization", [0, 1])
            s = np.char.mod("%.4f", rng.uniform(a, b, n))
            s[rng.random(n) < 0.03] = "-"
            cols[name] = s
        elif conf["transform"] == "vocab":
            pool = np.array([str(v) for v in conf["parameter"]])
            cols[name] = pool[rng.integers(0, len(pool), n)]
        elif conf["transform"] == "identity":
            cols[name] = np.char.mod("%d", rng.integers(
                0, conf["parameter"], n))
        else:  # hash_bucket: skewed ids like real logs
            # hash_spread: distinct-value cap per feature.  5000 (default)
            # gives learnable repetition for quality runs; None spreads
            # proportionally to the feature's hash space — REQUIRED for
            # kernel-path benchmarks, where an artificially collapsed id
            # set overflows the window plans' per-window entry caps and
            # flips the device onto the serial-scatter fallback branch
            # (bench.py e2e, round 5)
            spread = hash_spread or max(
                1000, min(int(conf["parameter"]), 1_000_000))
            ids = rng.zipf(1.3, n) % spread
            cols[name] = np.char.add(name[:2], np.char.mod("%d", ids))

    score = np.zeros(n)
    hour = cols["hour"].astype(int)
    score += np.where((hour >= 18) & (hour <= 23), 1.8, 0.0)
    score += np.where(np.isin(cols["site"], ["1", "2"]), 1.5, 0.0)
    age = np.where(cols["age"] == "-", "999", cols["age"]).astype(float)
    score += np.where(age < 30, 1.2, 0.0)
    score += np.where(cols["ugender"] == "male", 1.0, 0.0)
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if float(np.mean(1 / (1 + np.exp(-(score + mid))))) > pos_rate:
            hi = mid
        else:
            lo = mid
    p = 1 / (1 + np.exp(-(score + (lo + hi) / 2)))
    if n_classes == 2:
        label = (rng.random(n) < p).astype(int)
        achieved = float(label.mean())
    else:
        # n_classes quantile edges, not a hardcoded tercile: a 4-class
        # request must actually contain class 3
        noisy = p + rng.normal(0, 0.05, n)
        edges = np.quantile(noisy, [i / n_classes
                                    for i in range(1, n_classes)])
        label = np.digitize(noisy, edges)
        achieved = float(np.mean(label == 1))
    labels = np.char.mod("%d", label)

    with open(path, "w") as f:
        mat = [labels] + [cols[c] for c in schema[1:]]
        chunk = 100_000
        for s in range(0, n, chunk):
            block = ["\t".join(vals) for vals in
                     zip(*(m[s:s + chunk] for m in mat))]
            f.write("\n".join(block) + "\n")
    return achieved


def synthetic_batch(plan, batch_size, rng):
    """Packed-pool train batch with realistic id ranges and occupancy
    (singles = 1 entry, multivalue slots ~2 entries, the sample-data
    density) plus the kernel plans its groups carry; ``rng`` is a numpy
    Generator.  The port's copy of bench.py's synthetic_batch."""
    import numpy as np

    from wide_deep_tpu_torch.features.pipeline import train_plans
    batch = {}
    batch["label"] = (rng.random(batch_size) < 0.3).astype(np.float32)
    batch["weight"] = np.ones(batch_size, np.float32)
    batch["mask"] = np.ones(batch_size, np.float32)

    Pw = plan.wide_packed_len
    wide_ids = np.zeros((batch_size, Pw), np.int32)
    wide_wts = np.zeros((batch_size, Pw), np.float32)
    cur = 0
    for s in plan.wide_slots:
        if s.folded:
            continue  # wide weight rides the fused embedding gather
        occ = 1 if s.max_len == 1 else 2
        occ = min(occ, Pw - cur)
        if occ <= 0:
            break
        ids = rng.integers(0, s.size, (batch_size, occ))
        wide_ids[:, cur:cur + occ] = s.offset + ids
        wide_wts[:, cur:cur + occ] = 1.0
        cur += occ
    batch["wide_ids"], batch["wide_wts"] = wide_ids, wide_wts

    for g in plan.groups:
        P = plan.group_packed_len[g.dim]
        ids = np.zeros((batch_size, P), np.int32)
        wts = np.zeros((batch_size, P), np.float32)
        seg = np.zeros((batch_size, P), np.int32)
        cur = 0
        for s in g.slots:
            occ = 1 if s.max_len == 1 else 2
            occ = min(occ, P - cur)
            if occ <= 0:
                break
            ids[:, cur:cur + occ] = (
                s.row_offset + rng.integers(0, s.vocab_size,
                                            (batch_size, occ)))
            wts[:, cur:cur + occ] = 1.0 / occ
            seg[:, cur:cur + occ] = s.index
            cur += occ
        batch[f"emb_ids_d{g.dim}"], batch[f"emb_wts_d{g.dim}"] = ids, wts
        batch[f"emb_seg_d{g.dim}"] = seg
        batch.update(train_plans(plan, g, batch_size, ids, wts))

    if plan.indicator_total_len:
        ids = np.zeros((batch_size, plan.indicator_total_len), np.int32)
        wts = np.zeros((batch_size, plan.indicator_total_len), np.float32)
        for s in plan.indicator_slots:
            ids[:, s.col_offset] = s.offset + rng.integers(
                0, s.size, batch_size)
            wts[:, s.col_offset] = 1.0
        batch["ind_ids"], batch["ind_wts"] = ids, wts
    if plan.continuous_slots:
        batch["cont"] = rng.random(
            (batch_size, len(plan.continuous_slots))).astype(np.float32)
    return batch


# --------------------------------------------------------------- CNN checks
# The CNN arm on the card against the port on the host, with the CPU tests'
# tolerances (tests/test_torch_cnn.py): float32 logits within 1e-4 of the
# host's largest, BN state within 1e-4 by norm; float64 logits, gradients
# and BN state within 1e-10.  float32 gradients are held only for VGG,
# within 1e-2 by norm (a max-pool or ReLU near-tie routes them by the last
# bit); a ResNet's only in float64.
CNN_FWD_TOL = 1e-4
CNN_STATE_TOL = 1e-4
CNN_F64_TOL = 1e-10
VGG_GRAD_TOL = 1e-2


def cnn_forward_backward(spec, params, state, images, cot, training=True):
    """The CNN arm's (logits, new BN state, {path: gradient of sum(logits *
    cot)}) from copies of ``params`` (and ``state``) on ``images``' device
    and in its dtype."""
    import torch

    from wide_deep_tpu_torch.models.cnn import cnn_logits
    from wide_deep_tpu_torch.optim import tree_items
    dev, dt = images.device, images.dtype
    leaves = [(p, t.detach().to(dev, dt).requires_grad_(True))
              for p, t in tree_items(params)]
    tree: dict = {}
    for path, t in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    st = {k: {s: v.to(dev, dt) for s, v in d.items()}
          for k, d in (state or {}).items()}
    logits, new_state = cnn_logits(tree, spec, images, cot.shape[1],
                                   training, st or None)
    grads = torch.autograd.grad((logits * cot.to(dev, dt)).sum(),
                                [t for _, t in leaves])
    return (logits.detach(), new_state,
            {p: g for (p, _), g in zip(leaves, grads)})


def cnn_disagreement(spec, host, card, with_grads: bool):
    """How far ``card``'s ``cnn_forward_backward`` lies from ``host``'s:
    {"logits": max abs error over the host's largest, "state": worst BN
    leaf by norm, "grads": worst gradient leaf by norm, or None} and
    whether each is within the tolerance of its dtype (float64: every
    entry within CNN_F64_TOL; float32: logits and state as above, and with
    ``with_grads`` every gradient leaf within VGG_GRAD_TOL)."""
    import torch

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).norm() / b.norm().clamp_min(1e-300))
    hl, hs, hg = host
    cl, cs, cg = card
    f64 = hl.dtype == torch.float64
    out = {"logits": float((cl.double().cpu() - hl.double()).abs().max()
                           / hl.double().abs().max()),
           "state": max([rel(cs[k][s], hs[k][s]) for k in hs
                         for s in hs[k]] or [0.0]),
           "grads": None}
    ok = (out["logits"] <= (CNN_F64_TOL if f64 else CNN_FWD_TOL)
          and out["state"] <= (CNN_F64_TOL if f64 else CNN_STATE_TOL)
          and sorted(hs) == sorted(cs))
    if with_grads:
        out["grads"] = max(rel(cg[p], hg[p]) for p in hg)
        ok = ok and out["grads"] <= (CNN_F64_TOL if f64 else VGG_GRAD_TOL)
    out["ok"] = bool(ok)
    return out
