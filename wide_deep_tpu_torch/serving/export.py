"""Export bundles: the SavedModel analog (the port's counterpart of the JAX
package's ``serving/export.py``).

The reference exported a TF SavedModel by rebuilding feature columns and
calling ``export_savedmodel`` (its python/tensorflow_serving/
export_savedmodel.py:42-80).  A bundle is a versioned directory

  <export_dir>/<version>/
      params/          tensors.pt + index.json of {params, mstate}
                       (training/checkpoint.write_flat: flat names such as
                       ``params/dnn/embed/d32``, read back with
                       ``weights_only`` and ``mmap``)
      bundle.json      feature-plan dict + model config + conf-file copies
      params.txt       (optional, as_text) human-readable tensor dump

holding everything serving needs: the compiled feature plan (so the server
hashes and crosses as training did, without the original conf dir), the
model definition and the trained parameters.  ``bundle.json``, ``params.txt``
and the tensors' names, shapes, dtypes and values are the JAX package's;
only the tensors' container differs (the JAX bundle holds an orbax
checkpoint, which the port does not read).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from wide_deep_tpu_torch.config import Config
from wide_deep_tpu_torch.features.plan import FeaturePlan
from wide_deep_tpu_torch.models.joint import (WideDeep, build_model,
                                              resolve_device)
from wide_deep_tpu_torch.training import checkpoint as ckpt

BUNDLE_FILE = "bundle.json"
PARAMS_DIR = "params"


def abstract_state(model: WideDeep) -> Dict[str, Any]:
    """{"params", "mstate"} of ``model`` on the ``meta`` device: the shapes
    and dtypes of a serving model's leaves (the CNN arm's too, where the
    model has one), with nothing drawn or allocated (the production tables
    are gigabytes)."""
    meta = torch.device("meta")
    params, mstate = model.init(0, model.sample_batch(meta), meta)
    return {"params": params, "mstate": mstate}


def _rebuild(tree, leaves: Dict[str, Any], prefix: Tuple = ()):
    """``tree``'s nesting with each leaf replaced by ``leaves[its name]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves, prefix + (i,)) for i, v in enumerate(tree)]
    return leaves[ckpt.leaf_name(prefix)]


def _slim(name: str, want: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of the checkpoint's ``leaf`` as the serving model's leaf
    ``want`` has it.  Fused sparse tables (optim/sparse.py) keep optimizer
    slots in extra float32 columns ([rows, 2 * dim] on disk); the bundle
    carries only the embedding block in the serving dtype: the serving model
    is unfused, and a fat table would also double the bundle."""
    # >=, not >: a fused table with no optimizer slots (SGD) is already at
    # the serving width but still float32, and the cast must still happen
    if (want.dim() == 2 and leaf.dim() == 2
            and leaf.shape[0] == want.shape[0]
            and leaf.shape[1] >= want.shape[1]):
        leaf = leaf[:, :want.shape[1]]
    if leaf.shape != want.shape:
        raise ValueError(f"{name}: the checkpoint holds "
                         f"{tuple(leaf.shape)}, the serving model "
                         f"{tuple(want.shape)}")
    # a copy of its own: a view would write its whole storage
    out = torch.empty(want.shape, dtype=want.dtype)
    out.copy_(leaf)
    return out


def _plan(config: Config, model_type: str, checkpoint_path: Optional[str],
          model_dir: Optional[str]) -> FeaturePlan:
    """The serving FeaturePlan: no kernel plans and no sparse optimizer,
    with the fold and pack budget the checkpoint's params were trained
    with (its plan_meta.json) where that record exists."""
    from wide_deep_tpu_torch.features.analyze import (load_plan_meta,
                                                      resolve_pack_budget)
    from wide_deep_tpu_torch.features.plan import fold_enabled
    from wide_deep_tpu_torch.training.loop import resolve_checkpoint
    # an explicit checkpoint_path may name another run than the configured
    # model dir: its own record, beside its steps, is the one to trust
    meta = None
    if checkpoint_path:
        meta = load_plan_meta(resolve_checkpoint(checkpoint_path)[0])
    if meta is None:
        meta = load_plan_meta(os.path.join(
            model_dir or config.train["model_dir"], model_type))
    return FeaturePlan(
        config,
        fold=(meta["fold"] if meta else fold_enabled(config, model_type)),
        pack_budget=(meta["pack_budget"] if meta
                     else resolve_pack_budget(config)))


def export_savedmodel(config: Config, export_dir: str,
                      model_type: Optional[str] = None,
                      checkpoint_path: Optional[str] = None,
                      model_version: int = 1,
                      as_text: bool = False,
                      model_dir: Optional[str] = None,
                      n_classes: int = 2) -> str:
    """Train-side export: the checkpoint ``checkpoint_path`` names
    (``training/loop.resolve_checkpoint``: a step, or the latest of a model
    dir), else the latest under ``<model_dir>/<model_type>``, written as a
    bundle.  A missing checkpoint raises FileNotFoundError: exporting fresh
    params would give a valid-looking, untrained bundle.  Runs on the host.
    -> the versioned bundle path."""
    from wide_deep_tpu_torch.training.loop import resolve_checkpoint
    model_type = model_type or config.serving["model_type"]
    plan = _plan(config, model_type, checkpoint_path, model_dir)
    model = build_model(config, plan=plan, model_type=model_type,
                        n_classes=n_classes)
    abstract = abstract_state(model)

    if checkpoint_path:
        ckpt_dir, step = resolve_checkpoint(checkpoint_path)
    else:
        ckpt_dir = os.path.abspath(os.path.join(
            model_dir or config.train["model_dir"], model_type))
        step = None
    steps = ckpt.committed_steps(ckpt_dir)
    if step is None and steps:
        step = steps[-1]
    if step is None or step not in steps:
        raise FileNotFoundError(
            f"no checkpoint to export at {checkpoint_path or ckpt_dir!r} "
            f"(available steps: {steps})")
    stored = ckpt.load_tensors(ckpt_dir, step)
    wanted = dict(ckpt.named_leaves(abstract))
    have = {n for n in stored if n.split("/", 1)[0] in abstract}
    if have != set(wanted):
        raise ValueError(
            f"checkpoint step {step} in {ckpt_dir} does not fit the "
            f"serving model: missing {sorted(set(wanted) - have)}, extra "
            f"{sorted(have - set(wanted))}")
    tensors = {n: _slim(n, w, stored[n]) for n, w in wanted.items()}
    del stored

    bundle = {
        "format_version": 1,
        "model_type": model_type,
        "n_classes": n_classes,
        "global_step": int(step),
        "plan": plan.to_dict(),
        "model_conf": _jsonable(config.model),
        "train_conf": {"multivalue": config.train["multivalue"]},
        "conf_files": _conf_files(config),
    }
    # written beside the version dir and renamed into place: a server that
    # watches export_dir for new versions never loads a half-written one
    root = os.path.abspath(export_dir)
    version_dir = os.path.join(root, str(model_version))
    tmp = os.path.join(root, f".{model_version}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    ckpt.write_flat(os.path.join(tmp, PARAMS_DIR), tensors, {})
    with open(os.path.join(tmp, BUNDLE_FILE), "w") as f:
        json.dump(bundle, f)
    if as_text:
        params = _rebuild(abstract, tensors)["params"]
        with open(os.path.join(tmp, "params.txt"), "w") as f:
            for name, leaf in _sorted_leaves(params):
                arr = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
                    else leaf.numpy()
                dtype = str(leaf.dtype).removeprefix("torch.")
                f.write(f"{name} {tuple(leaf.shape)} {dtype}\n")
                np.savetxt(f, arr.reshape(-1)[:64][None], fmt="%.6g")
    if os.path.isdir(version_dir):
        shutil.rmtree(version_dir)
    os.replace(tmp, version_dir)
    return version_dir


def _sorted_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Leaves in the JAX package's tree order (dict keys sorted, lists in
    order), named as its params.txt names them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _sorted_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _conf_files(config: Config) -> Dict[str, str]:
    out = {}
    for name in ("schema", "feature", "cross_feature", "model"):
        path = os.path.join(config.conf_dir, name + ".yaml")
        if os.path.exists(path):
            with open(path) as f:
                out[name + ".yaml"] = f.read()
    return out


def _build(config: Config, bundle: Dict[str, Any]) -> WideDeep:
    plan = FeaturePlan(config, multivalue=bundle["train_conf"]["multivalue"],
                       fold=bundle["plan"].get("fold", False),
                       pack_budget=bundle["plan"].get("pack_budget"),
                       # pin the trained fold layout even if the embedded
                       # conf copy is later hand-edited: folded-ness decides
                       # which table carries each wide weight
                       fold_max_rows=bundle["plan"].get("fold_max_rows"))
    return build_model(config, plan=plan, model_type=bundle["model_type"],
                       n_classes=bundle["n_classes"])


def load_bundle(version_dir: str, config: Optional[Config] = None,
                device=None) -> Tuple[WideDeep, Dict, Dict, Dict]:
    """Serving-side load: -> (model, params, mstate, bundle_meta), the
    tensors on ``device`` (the card unless the caller passes
    ``device="cpu"``).

    Without ``config``, the plan is rebuilt from the bundle's embedded conf
    files, so the serving host needs no configuration of its own; the
    train, serving and data_process files come from the default conf dir.
    The names, shapes and dtypes of the stored tensors must be the serving
    model's."""
    device = resolve_device(device)
    with open(os.path.join(version_dir, BUNDLE_FILE)) as f:
        bundle = json.load(f)
    if config is not None:
        model = _build(config, bundle)
    else:
        with tempfile.TemporaryDirectory(prefix="wdt_serving_conf_") as d:
            base = Config()
            for name in ("train", "serving", "data_process"):
                src = os.path.join(base.conf_dir, name + ".yaml")
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(d, name + ".yaml"))
            for name, text in bundle["conf_files"].items():
                with open(os.path.join(d, name), "w") as f:
                    f.write(text)
            config = Config(d)
            model = _build(config, bundle)
            # read every file while the directory exists (Config caches
            # what it reads)
            config.config
            config.data_process
    abstract = abstract_state(model)
    stored = ckpt.load_flat(os.path.join(version_dir, PARAMS_DIR))
    wanted = dict(ckpt.named_leaves(abstract))
    if set(stored) != set(wanted):
        raise ValueError(
            f"{version_dir}: the bundle does not fit its model: missing "
            f"{sorted(set(wanted) - set(stored))}, extra "
            f"{sorted(set(stored) - set(wanted))}")
    for name, want in wanted.items():
        got = stored[name]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"{name}: the bundle holds {tuple(got.shape)} "
                             f"{got.dtype}, the model {tuple(want.shape)} "
                             f"{want.dtype}")
    tree = _rebuild(abstract, {n: t.to(device) for n, t in stored.items()})
    return model, tree["params"], tree["mstate"], bundle


def latest_version_dir(export_root: str) -> str:
    versions = [d for d in os.listdir(export_root) if d.isdigit()]
    if not versions:
        raise FileNotFoundError(f"no version dirs under {export_root}")
    return os.path.join(export_root, max(versions, key=int))
