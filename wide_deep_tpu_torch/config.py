"""Typed configuration stack for wide_deep_tpu_torch.

The port's own copy of ``wide_deep_tpu/config.py`` (PyYAML only).  Loads and
validates the seven YAML surfaces under ``conf/`` and exposes the same
logical API as the reference config system (reference read_conf.py:11-279): ``read_schema``,
``read_feature_conf``, ``read_cross_feature_conf``, the ``train`` /
``distribution`` / ``runconfig`` / ``model`` / ``serving`` properties and
``get_feature_name``.

Deliberate divergences from the reference (documented for parity review):

* YAML files are parsed once and cached; call :meth:`Config.reload` to pick up
  edits (the reference re-read files on each property access,
  read_conf.py:235-257).
* Optimizer values given as ``tf.train.XxxOptimizer(...)`` constructor strings
  are parsed with a restricted grammar into a ``{name, **kwargs}`` dict — the
  reference ``eval()``'d them (model_util.py:96-105), which we do not replicate.
* The reference bug where a missing comma merged two config keys
  (read_conf.py:183-184) and the always-true normalization check
  (read_conf.py:82) are fixed, not replicated.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import yaml

# Feature-transform vocabulary.
CATEGORY_TRANSFORMS = ("hash_bucket", "vocab", "identity")
CONTINUOUS_TRANSFORMS = ("min_max", "log", "log1p", "standard")
# How a multi-valued embedding feature pools its rows (feature.yaml
# ``combiner``): the mean (the default) or the sum.
COMBINERS = ("mean", "sum")
# The longest multi-valued cell a feature may keep (feature.yaml
# ``max_len``): the native loader's split buffer (csrc/fastdata.cc
# kMaxValues) holds this many values.
MAX_LEN_CAP = 128

# Canonical optimizer names accepted by the registry (optim/__init__.py).
OPTIMIZER_NAMES = (
    "Adagrad", "Adam", "Ftrl", "RMSProp", "SGD", "Momentum", "ProximalAdagrad",
)
# The rules the fused touched-rows tables take (model.yaml
# ``dnn_embedding_optimizer``, optim/sparse.py); RowwiseAdagrad exists
# there alone: one accumulator a row.
EMBEDDING_OPTIMIZER_NAMES = (
    "Adagrad", "ProximalAdagrad", "Ftrl", "SGD", "RowwiseAdagrad",
)
# model.yaml ``dnn_interaction``: the layer between the input layer and the
# tower.  ``dcn``: the low-rank cross network of DCN-V2 (Wang et al.,
# arXiv:2008.13535), ``layers`` cross layers of rank ``rank``.
INTERACTION_TYPES = ("dcn",)

_TF_OPT_RE = re.compile(r"^tf\.train\.(\w+?)Optimizer\((.*)\)$", re.S)

# tf.train optimizer class stem -> canonical registry name.
_TF_OPT_NAME = {
    "Ftrl": "Ftrl",
    "Adagrad": "Adagrad",
    "Adam": "Adam",
    "RMSProp": "RMSProp",
    "GradientDescent": "SGD",
    "Momentum": "Momentum",
    "ProximalAdagrad": "ProximalAdagrad",
}


class ConfigError(ValueError):
    """Raised when a YAML config fails validation."""


def _load_yaml(path: str) -> Any:
    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        return yaml.safe_load(f)


def _require(mapping: Dict[str, Any], key: str, where: str) -> Any:
    if key not in mapping or mapping[key] is None:
        raise ConfigError(f"{where}: required key `{key}` is missing or empty")
    return mapping[key]


def _as_bool(value: Any, key: str, where: str) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, int) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.lower() in ("0", "1", "true", "false"):
        return value.lower() in ("1", "true")
    if value is None:
        return False
    raise ConfigError(f"{where}: key `{key}` must be boolean-like, got {value!r}")


def _as_number(value: Any, key: str, where: str, allow_none: bool = False):
    if value is None and allow_none:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ConfigError(f"{where}: key `{key}` must be numeric, got {value!r}")
    return value


def parse_optimizer_spec(value: Any, default_lr: float,
                         names: Tuple[str, ...] = OPTIMIZER_NAMES
                         ) -> Dict[str, Any]:
    """Normalize an optimizer config value into ``{name, learning_rate, ...}``.

    Accepts a bare registry name (``"Adagrad"``), a structured mapping
    (``{name: Ftrl, learning_rate: 0.1, ...}``), or — for compatibility with
    reference conf/model.yaml:14 — a ``tf.train.XxxOptimizer(k=v,...)``
    constructor string parsed with a restricted literal grammar (numbers and
    bare identifiers only; never evaluated as Python).
    """
    if value is None:
        raise ConfigError("optimizer spec must not be empty")
    if isinstance(value, dict):
        spec = dict(value)
        name = _require(spec, "name", "optimizer spec")
        if name not in names:
            raise ConfigError(
                f"unknown optimizer `{name}`; expected one of {names}")
        spec.setdefault("learning_rate", default_lr)
        return spec
    if isinstance(value, str):
        value = value.strip()
        m = _TF_OPT_RE.match(value)
        if m:
            stem, argstr = m.groups()
            if stem not in _TF_OPT_NAME or _TF_OPT_NAME[stem] not in names:
                raise ConfigError(f"unknown tf.train optimizer `{stem}`")
            spec: Dict[str, Any] = {"name": _TF_OPT_NAME[stem]}
            argstr = argstr.strip()
            if argstr:
                for part in argstr.split(","):
                    if not part.strip():
                        continue
                    if "=" not in part:
                        raise ConfigError(
                            f"optimizer string args must be keyword form: {part!r}")
                    k, v = part.split("=", 1)
                    k, v = k.strip(), v.strip()
                    try:
                        num = float(v)
                        spec[k] = int(num) if num == int(num) and "." not in v and "e" not in v.lower() else num
                    except ValueError:
                        raise ConfigError(
                            f"optimizer arg `{k}` must be numeric, got {v!r}")
            spec.setdefault("learning_rate", default_lr)
            return spec
        # bare registry name (case-insensitive)
        for name in names:
            if value.lower() == name.lower():
                return {"name": name, "learning_rate": default_lr}
        raise ConfigError(
            f"unknown optimizer `{value}`; expected one of {names} "
            "or a tf.train.XxxOptimizer(...) string")
    raise ConfigError(f"bad optimizer spec: {value!r}")


def _interaction(value: Any, where: str) -> Optional[Dict[str, Any]]:
    """model.yaml ``dnn_interaction`` -> None (off) or ``{type: dcn,
    layers: int, rank: int}``."""
    if value is None:
        return None
    if not isinstance(value, dict):
        raise ConfigError(f"{where}: dnn_interaction must be a mapping, "
                          f"got {value!r}")
    unknown = sorted(set(value) - {"type", "layers", "rank"})
    if unknown:
        raise ConfigError(f"{where}: dnn_interaction: unknown keys {unknown}")
    kind = value.get("type")
    if kind not in INTERACTION_TYPES:
        raise ConfigError(f"{where}: dnn_interaction type must be one of "
                          f"{INTERACTION_TYPES}, got {kind!r}")
    out: Dict[str, Any] = {"type": kind}
    for key in ("layers", "rank"):
        v = value.get(key)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ConfigError(f"{where}: dnn_interaction {key} must be a "
                              f"positive int, got {v!r}")
        out[key] = v
    return out


class Config:
    """Bound view over the seven YAML config files in ``conf_dir``.

    Reference parity: read_conf.py:11-39 binds the same seven paths.
    """

    def __init__(self, conf_dir: Optional[str] = None):
        if conf_dir is None:
            conf_dir = os.environ.get("WIDE_DEEP_CONF_DIR") or os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
        self.conf_dir = conf_dir
        self._paths = {
            name: os.path.join(conf_dir, name + ".yaml")
            for name in ("schema", "feature", "cross_feature", "model",
                         "train", "serving", "data_process")
        }
        self._cache: Dict[str, Any] = {}

    def reload(self) -> None:
        self._cache.clear()

    def _raw(self, name: str) -> Any:
        if name not in self._cache:
            self._cache[name] = _load_yaml(self._paths[name])
        return self._cache[name]

    # ------------------------------------------------------------------ schema
    def read_schema(self) -> Dict[int, str]:
        """Ordered ``{1-based index: lowercased column name}`` map.

        Accepts either our list form (conf/schema.yaml ``columns:``) or the
        reference's ``{index: name}`` map form (reference conf/schema.yaml:7-67).
        """
        raw = self._raw("schema")
        if isinstance(raw, dict) and "columns" in raw:
            cols = raw["columns"]
            if not isinstance(cols, list) or not cols:
                raise ConfigError("schema.yaml: `columns` must be a non-empty list")
            return {i + 1: str(c).lower() for i, c in enumerate(cols)}
        if isinstance(raw, dict):
            out = {}
            for k in sorted(raw):
                if not isinstance(k, int):
                    raise ConfigError(f"schema.yaml: bad index {k!r}")
                out[k] = str(raw[k]).lower()
            return out
        raise ConfigError("schema.yaml: unrecognized structure")

    def schema_columns(self) -> List[str]:
        schema = self.read_schema()
        return [schema[i] for i in sorted(schema)]

    @property
    def label_column(self) -> str:
        return self.schema_columns()[0]

    # ---------------------------------------------------------------- features
    def read_feature_conf(self) -> Dict[str, Dict[str, Any]]:
        """Validated per-feature conf (reference read_conf.py:49-141)."""
        raw = self._raw("feature") or {}
        schema_names = set(self.schema_columns())
        out: Dict[str, Dict[str, Any]] = {}
        for feature, conf in raw.items():
            feature = str(feature).lower()
            where = f"feature.yaml[{feature}]"
            if feature not in schema_names:
                raise ConfigError(f"{where}: not present in schema.yaml")
            if not isinstance(conf, dict):
                raise ConfigError(f"{where}: must be a mapping")
            ftype = str(_require(conf, "type", where)).lower()
            transform = conf.get("transform")
            parameter = conf.get("parameter")
            if ftype == "category":
                if transform not in CATEGORY_TRANSFORMS:
                    raise ConfigError(
                        f"{where}: category transform must be one of "
                        f"{CATEGORY_TRANSFORMS}, got {transform!r}")
                if transform in ("hash_bucket", "identity"):
                    if not isinstance(parameter, int) or parameter <= 0:
                        raise ConfigError(
                            f"{where}: `{transform}` parameter must be a "
                            f"positive int, got {parameter!r}")
                else:  # vocab
                    if isinstance(parameter, str):
                        # vocabulary file: one value per line (the
                        # categorical_column_with_vocabulary_file analog);
                        # relative paths resolve against the conf dir
                        path = parameter if os.path.isabs(parameter) else \
                            os.path.join(self.conf_dir, parameter)
                        if not os.path.exists(path):
                            raise ConfigError(
                                f"{where}: vocab file not found: {path}")
                        with open(path) as vf:
                            parameter = [line.rstrip("\n") for line in vf
                                         if line.strip()]
                    if not isinstance(parameter, list) or not parameter:
                        raise ConfigError(
                            f"{where}: vocab parameter must be a non-empty "
                            "list or a vocab file path")
            elif ftype == "continuous":
                if transform not in CONTINUOUS_TRANSFORMS and transform is not None:
                    raise ConfigError(
                        f"{where}: continuous transform must be one of "
                        f"{CONTINUOUS_TRANSFORMS} or empty, got {transform!r}")
                parameter = dict(parameter or {})
                norm = parameter.get("normalization")
                if transform in ("min_max", "standard"):
                    if (not isinstance(norm, list) or len(norm) != 2
                            or not all(isinstance(v, (int, float)) for v in norm)):
                        raise ConfigError(
                            f"{where}: `{transform}` needs normalization "
                            f"[a, b], got {norm!r}")
                    if transform == "min_max" and norm[0] >= norm[1]:
                        raise ConfigError(f"{where}: min_max requires min < max")
                    if transform == "standard" and norm[1] <= 0:
                        raise ConfigError(f"{where}: standard requires std > 0")
                bounds = parameter.get("boundaries")
                if bounds is not None:
                    if (not isinstance(bounds, list) or not bounds
                            or not all(isinstance(v, (int, float)) for v in bounds)
                            or sorted(bounds) != list(bounds)):
                        raise ConfigError(
                            f"{where}: boundaries must be a sorted numeric list")
            else:
                raise ConfigError(
                    f"{where}: type must be `category` or `continuous`")
            max_len = conf.get("max_len", 1)
            if not isinstance(max_len, int) or max_len < 1:
                raise ConfigError(f"{where}: max_len must be a positive int")
            if max_len > MAX_LEN_CAP:
                # hard contract with the native loader's fixed per-cell
                # split buffer (csrc/fastdata.cc kMaxValues) — reject at
                # config time instead of overflowing a worker stack
                raise ConfigError(
                    f"{where}: max_len must be <= {MAX_LEN_CAP} (native "
                    f"loader split-buffer contract), got {max_len}")
            if ftype == "continuous" and max_len != 1:
                raise ConfigError(f"{where}: continuous features are scalar")
            emb_dim = conf.get("embedding_dim")
            if emb_dim is not None:
                if (not isinstance(emb_dim, int) or emb_dim < 1
                        or transform != "hash_bucket"):
                    raise ConfigError(
                        f"{where}: embedding_dim must be a positive int on a "
                        "hash_bucket feature")
            combiner = conf.get("combiner")
            if combiner is not None and (combiner not in COMBINERS
                                         or transform != "hash_bucket"):
                raise ConfigError(
                    f"{where}: combiner must be one of {COMBINERS} on a "
                    f"hash_bucket feature, got {combiner!r}")
            out[feature] = {"type": ftype, "transform": transform,
                            "parameter": parameter, "max_len": max_len,
                            "embedding_dim": emb_dim}
            # the new keys appear only where set: a conf without them
            # reads as the JAX package's does
            if combiner is not None:
                out[feature]["combiner"] = combiner
        return out

    # ----------------------------------------------------------------- crosses
    def read_cross_feature_conf(self) -> List[Tuple[List[str], int, bool]]:
        """Validated crosses: ``[(member_names, hash_bucket_size, is_deep)]``.

        ``hash_bucket_size`` in the YAML is in thousands (reference
        read_conf.py:111-154, defaults 10 -> 10_000 ids); returned here as the
        final id count.
        """
        raw = self._raw("cross_feature") or {}
        feature_conf = self.read_feature_conf()
        out = []
        for key, conf in raw.items():
            where = f"cross_feature.yaml[{key}]"
            members = [m.strip().lower() for m in str(key).split("&")]
            if len(members) < 2:
                raise ConfigError(f"{where}: need at least 2 member features")
            if len(set(members)) != len(members):
                raise ConfigError(f"{where}: duplicate member feature")
            for m in members:
                if m not in feature_conf:
                    raise ConfigError(f"{where}: member `{m}` not in feature.yaml")
                fc = feature_conf[m]
                if fc["type"] == "continuous" and not (
                        fc["parameter"] or {}).get("boundaries"):
                    raise ConfigError(
                        f"{where}: continuous member `{m}` must define "
                        "`boundaries` to participate in a cross")
            conf = dict(conf or {})
            size_k = conf.get("hash_bucket_size")
            if size_k is None:
                size_k = 10
            size_k = _as_number(size_k, "hash_bucket_size", where)
            bucket_size = int(round(size_k * 1000))
            if bucket_size <= 0:
                raise ConfigError(f"{where}: hash_bucket_size must be positive")
            is_deep = conf.get("is_deep")
            is_deep = True if is_deep is None else _as_bool(is_deep, "is_deep", where)
            out.append((members, bucket_size, is_deep))
        return out

    # ------------------------------------------------------------------- model
    @property
    def model(self) -> Dict[str, Any]:
        raw = dict(self._raw("model") or {})
        where = "model.yaml"
        out: Dict[str, Any] = {}

        def _initial_lr(key: str) -> float:
            # unset -> 0.05 default; an explicit 0/negative is a config
            # mistake and must fail loudly, not be silently replaced
            # (an `or`-default here once turned an explicit 0 into 0.05)
            v = raw.get(key)
            if v is None:
                return 0.05
            v = _as_number(v, key, where)
            if v <= 0:
                raise ConfigError(
                    f"{where}: {key} must be > 0, got {v!r} "
                    f"(omit the key for the default 0.05)")
            return float(v)

        lin_lr = _initial_lr("linear_initial_learning_rate")
        dnn_lr = _initial_lr("dnn_initial_learning_rate")
        cnn_lr = _initial_lr("cnn_initial_learning_rate")
        out["linear_initial_learning_rate"] = lin_lr
        out["dnn_initial_learning_rate"] = dnn_lr
        out["cnn_initial_learning_rate"] = cnn_lr
        out["linear_optimizer"] = parse_optimizer_spec(
            _require(raw, "linear_optimizer", where), lin_lr)
        out["dnn_optimizer"] = parse_optimizer_spec(
            _require(raw, "dnn_optimizer", where), dnn_lr)
        out["cnn_optimizer"] = parse_optimizer_spec(
            raw.get("cnn_optimizer", "Adagrad"), cnn_lr)
        # the fused touched-rows tables' own rule; unset: dnn_optimizer's
        emb_opt = raw.get("dnn_embedding_optimizer")
        if emb_opt is not None:
            out["dnn_embedding_optimizer"] = parse_optimizer_spec(
                emb_opt, dnn_lr, EMBEDDING_OPTIMIZER_NAMES)
        out["linear_fm_factors"] = int(raw.get("linear_fm_factors") or 0)
        # wide fold: store hash/deep-cross wide weights as trailing columns
        # of their fused embedding tables (features/plan.py "wide fold");
        # default on — same math on the same gradients (~halves device id
        # traffic); with bfloat16 tables the folded wide weights are READ at
        # bf16 precision (f32 master copies, like the embeddings) — measured
        # AUC parity on the bundled data (tests/test_fold.py bf16 case)
        wf = raw.get("wide_fold")
        out["wide_fold"] = True if wf is None else _as_bool(
            wf, "wide_fold", where)
        # unset -> None (plan falls back to its default cap); explicit 0 is
        # honored and means "fold no tables" (equivalent to wide_fold: false)
        wfmr = raw.get("wide_fold_max_rows")
        if wfmr is None:
            out["wide_fold_max_rows"] = None
        else:
            wfmr = int(_as_number(wfmr, "wide_fold_max_rows", where))
            if wfmr < 0:
                raise ConfigError(
                    f"{where}: wide_fold_max_rows must be >= 0, got {wfmr}")
            out["wide_fold_max_rows"] = wfmr
        for key in ("linear_decay_rate", "dnn_decay_rate", "cnn_decay_rate"):
            v = _as_number(raw.get(key), key, where, allow_none=True)
            out[key] = 1.0 if v in (None, 0) else float(v)

        hidden = _require(raw, "dnn_hidden_units", where)
        if not isinstance(hidden, list) or not hidden:
            raise ConfigError(f"{where}: dnn_hidden_units must be a non-empty list")
        out["dnn_hidden_units"] = hidden
        bottom = raw.get("dnn_bottom_units")
        if bottom is not None and (
                not isinstance(bottom, list) or not bottom
                or not all(isinstance(u, int) and not isinstance(u, bool)
                           and u > 0 for u in bottom)):
            raise ConfigError(f"{where}: dnn_bottom_units must be a "
                              f"non-empty list of positive ints, got "
                              f"{bottom!r}")
        if bottom and not self.get_feature_name("continuous"):
            raise ConfigError(f"{where}: dnn_bottom_units needs continuous "
                              f"features to take")
        if bottom:
            out["dnn_bottom_units"] = list(bottom)
        interaction = _interaction(raw.get("dnn_interaction"), where)
        if interaction is not None:
            out["dnn_interaction"] = interaction
        out["dnn_connected_mode"] = raw.get("dnn_connected_mode", "simple")
        act = str(raw.get("dnn_activation_function", "relu")).lower()
        out["dnn_activation_function"] = act
        out["dnn_l1"] = float(_as_number(raw.get("dnn_l1"), "dnn_l1", where,
                                         allow_none=True) or 0.0)
        out["dnn_l2"] = float(_as_number(raw.get("dnn_l2"), "dnn_l2", where,
                                         allow_none=True) or 0.0)
        out["dnn_dropout"] = float(_as_number(raw.get("dnn_dropout"), "dnn_dropout",
                                              where, allow_none=True) or 0.0)
        out["dnn_batch_normalization"] = _as_bool(
            raw.get("dnn_batch_normalization"), "dnn_batch_normalization", where)
        for dkey in ("embedding_dtype", "dense_dtype"):
            val = str(raw.get(dkey) or "float32").lower()
            if val not in ("float32", "bfloat16"):
                raise ConfigError(f"{where}: {dkey} must be float32|bfloat16")
            out[dkey] = val

        out["cnn_use_flag"] = _as_bool(raw.get("cnn_use_flag"), "cnn_use_flag", where)
        out["cnn_model"] = str(raw.get("cnn_model", "vgg16")).lower()
        out["cnn_height"] = int(raw.get("cnn_height") or 224)
        out["cnn_width"] = int(raw.get("cnn_width") or 224)
        out["cnn_num_channels"] = int(raw.get("cnn_num_channels") or 3)
        out["cnn_resnet_size"] = int(raw.get("cnn_resnet_size") or 50)
        return out

    # ------------------------------------------------------------------- train
    @property
    def train(self) -> Dict[str, Any]:
        raw = self._raw("train") or {}
        section = dict(raw.get("train") or {})
        where = "train.yaml[train]"
        out = dict(section)
        out["model_dir"] = str(_require(section, "model_dir", where))
        mt = str(_require(section, "model_type", where)).lower()
        if mt not in ("wide", "deep", "wide_deep"):
            raise ConfigError(f"{where}: model_type must be wide|deep|wide_deep")
        out["model_type"] = mt
        out["train_data"] = str(_require(section, "train_data", where))
        out["eval_data"] = str(_require(section, "eval_data", where))
        out["test_data"] = str(_require(section, "test_data", where))
        out["dynamic_train"] = _as_bool(section.get("dynamic_train"),
                                        "dynamic_train", where)
        out["train_epochs"] = int(_as_number(section.get("train_epochs", 1),
                                             "train_epochs", where))
        out["epochs_per_eval"] = int(_as_number(section.get("epochs_per_eval", 1),
                                                "epochs_per_eval", where))
        out["batch_size"] = int(_as_number(
            _require(section, "batch_size", where), "batch_size", where))
        out["keep_train"] = _as_bool(section.get("keep_train"), "keep_train", where)
        out["multivalue"] = _as_bool(section.get("multivalue"), "multivalue", where)
        out["num_examples"] = int(_as_number(section.get("num_examples", 10000),
                                             "num_examples", where))
        for key in ("pos_sample_loss_weight", "neg_sample_loss_weight"):
            out[key] = _as_number(section.get(key), key, where, allow_none=True)
        npc = section.get("num_parallel_calls")
        out["num_parallel_calls"] = int(npc) if npc else None
        pb = section.get("pack_budget")
        # int = fixed pool capacity; "auto" = p95-occupancy sizing resolved
        # by callers that can see the data (features/analyze.py)
        if pb in (None, ""):
            out["pack_budget"] = 3
        elif str(pb).lower() == "auto":
            out["pack_budget"] = "auto"
        else:
            out["pack_budget"] = int(pb)
        for key in ("image_train_data", "image_eval_data", "image_test_data",
                    "checkpoint_path"):
            out[key] = section.get(key) or None
        return out

    @property
    def distribution(self) -> Dict[str, Any]:
        raw = self._raw("train") or {}
        section = dict(raw.get("distribution") or {})
        where = "train.yaml[distribution]"
        out = dict(section)
        out["is_distribution"] = _as_bool(section.get("is_distribution"),
                                          "is_distribution", where)
        out["coordinator"] = section.get("coordinator")
        out["num_processes"] = int(section.get("num_processes") or 1)
        out["process_index"] = int(section.get("process_index") or 0)
        mesh = dict(section.get("mesh") or {"data": -1, "model": 1})
        for axis, size in mesh.items():
            if not isinstance(size, int):
                raise ConfigError(f"{where}: mesh axis `{axis}` must be int")
        out["mesh"] = mesh
        lookup = section.get("sharded_lookup") or "auto"
        if lookup not in ("auto", "gspmd", "explicit", "dedup"):
            raise ConfigError(
                f"{where}: sharded_lookup must be auto|gspmd|explicit|dedup,"
                f" got {lookup!r}")
        out["sharded_lookup"] = lookup
        # input_service: "host:port" of a tools/input_server.py loader — a
        # process that sees the GLOBAL batch, so multi-process meshes keep
        # the per-shard kernel plans (features/input_service.py); a
        # comma-separated list shards the loaders over contiguous proc
        # groups (pod scale); empty = per-host row sharding
        # (pipeline.CsvDataset).  Each entry must be host:port with a
        # numeric port — catching a typo here beats an int() ValueError
        # on half the pod mid-startup.
        svc = section.get("input_service") or ""
        for entry in str(svc).split(","):
            entry = entry.strip()
            if not entry:
                continue  # empty string / stray comma (loop.py strips too)
            host, _, port = entry.rpartition(":")
            if not host or not port.isdigit():
                raise ConfigError(
                    f"{where}: input_service entries must be host:port, "
                    f"got {entry!r} in {svc!r}")
            if not 1 <= int(port) <= 65535:
                raise ConfigError(
                    f"{where}: input_service port must be 1-65535, "
                    f"got {port} in {entry!r}")
        out["input_service"] = str(svc)
        return out

    @property
    def runconfig(self) -> Dict[str, Any]:
        raw = self._raw("train") or {}
        section = dict(raw.get("runconfig") or {})
        where = "train.yaml[runconfig]"
        out = {}
        # explicit None check: tf_random_seed: 0 is a legal pinned seed
        # and must not silently become the 123 default (falsy-zero class)
        raw_seed = section.get("tf_random_seed")
        out["tf_random_seed"] = int(123 if raw_seed in (None, "")
                                    else raw_seed)
        out["save_summary_steps"] = int(section.get("save_summary_steps") or 100)
        steps = section.get("save_checkpoints_steps")
        secs = section.get("save_checkpoints_secs")
        if steps and secs:
            raise ConfigError(
                f"{where}: set only one of save_checkpoints_steps / _secs")
        out["save_checkpoints_steps"] = int(steps) if steps else None
        out["save_checkpoints_secs"] = int(secs) if secs else (
            None if steps else 600)
        out["keep_checkpoint_max"] = int(section.get("keep_checkpoint_max") or 5)
        out["keep_checkpoint_every_n_hours"] = int(
            section.get("keep_checkpoint_every_n_hours") or 10000)
        out["log_step_count_steps"] = int(
            section.get("log_step_count_steps") or 100)
        return out

    # ----------------------------------------------------------------- serving
    @property
    def serving(self) -> Dict[str, Any]:
        raw = self._raw("serving") or {}
        section = dict(raw.get("SavedModel") or {})
        where = "serving.yaml[SavedModel]"
        out = dict(section)
        out["model_dir"] = str(_require(section, "model_dir", where))
        out["model_type"] = str(_require(section, "model_type", where)).lower()
        out["model_version"] = int(section.get("model_version") or 1)
        out["as_text"] = _as_bool(section.get("as_text"), "as_text", where)
        out["checkpoint_path"] = section.get("checkpoint_path") or None
        server = dict(raw.get("server") or {})
        out["server"] = {
            "port": int(server.get("port") or 8500),
            "model_name": str(server.get("model_name") or "wide_deep"),
            "max_batch_size": int(server.get("max_batch_size") or 1024),
            "batch_timeout_micros": int(server.get("batch_timeout_micros") or 0),
            # shared-secret request auth (empty = open, like the reference's
            # tensorflow_model_server)
            "auth_token": str(server.get("auth_token") or ""),
            # TLS on both transports (empty = plaintext); tls_ca enables
            # mutual TLS (clients must present a cert the CA signed)
            "tls_cert": str(server.get("tls_cert") or ""),
            "tls_key": str(server.get("tls_key") or ""),
            "tls_ca": str(server.get("tls_ca") or ""),
        }
        return out

    @property
    def data_process(self) -> Dict[str, Any]:
        raw = dict(self._raw("data_process") or {})
        out = dict(raw)
        out["category_feature_index_list"] = raw.get(
            "category_feature_index_list") or []
        out["downsampling_keep_ratio"] = float(
            raw.get("downsampling_keep_ratio") or 1.0)
        return out

    @property
    def config(self) -> Dict[str, Any]:
        """Everything at once (reference read_conf.py:235-238)."""
        return {
            "train": self.train,
            "distribution": self.distribution,
            "runconfig": self.runconfig,
            "model": self.model,
            "serving": self.serving,
        }

    # ------------------------------------------------------------ feature sets
    def get_feature_name(self, feature_type: str = "all") -> List[str]:
        """Feature-name lists by kind (reference read_conf.py:259-279).

        ``all`` = every schema column except the label; ``used`` = features
        configured in feature.yaml; ``unused`` = the rest; ``category`` /
        ``continuous`` = used features of that type.
        """
        schema = self.schema_columns()
        label = schema[0]
        all_names = [c for c in schema if c != label]
        feature_conf = self.read_feature_conf()
        used = [c for c in all_names if c in feature_conf]
        if feature_type == "all":
            return all_names
        if feature_type == "used":
            return used
        if feature_type == "unused":
            return [c for c in all_names if c not in feature_conf]
        if feature_type in ("category", "continuous"):
            return [c for c in used if feature_conf[c]["type"] == feature_type]
        raise ConfigError(f"unknown feature_type `{feature_type}`")
