"""Estimator-style facade: familiar class names for reference users (the
port's copy of the JAX package's ``estimator.py``).

The reference exposed ``WideAndDeepClassifier`` (joint.py:272-433),
``MultiDNNClassifier`` (dnn.py:298-443) and the builders
``build_estimator`` / ``build_custom_estimator``
(build_estimator.py:201-294).  This module offers the same surface,
``train / evaluate / predict / export_savedmodel``, as a thin veneer over
the port's Trainer.  Each runs on the card unless it is given
``device="cpu"``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Iterator, List, Optional

from wide_deep_tpu_torch.config import Config
from wide_deep_tpu_torch.training.loop import Trainer


class _EstimatorBase:
    """train/evaluate/predict surface over a Trainer."""

    def __init__(self, trainer: Trainer):
        self._trainer = trainer
        self.model_dir = trainer.model_dir

    # -- tf.estimator-like API ------------------------------------------------
    def train(self, input_data: str, epochs: int = 1) -> "_EstimatorBase":
        """Train over a file/dir for ``epochs`` passes."""
        from wide_deep_tpu_torch.features.pipeline import list_files
        self._trainer.ensure_initialized()
        for epoch in range(epochs):
            for path in list_files(input_data):
                self._trainer.train_file(path, epoch_seed=epoch)
        self._trainer.save()
        return self

    def evaluate(self, input_data: str,
                 checkpoint_path: Optional[str] = None) -> Dict[str, float]:
        return self._trainer.evaluate(input_data,
                                      checkpoint_path=checkpoint_path)

    def predict(self, input_data: str) -> Iterator[Dict[str, Any]]:
        return self._trainer.predict(input_data)

    def export_savedmodel(self, export_dir: str, model_version: int = 1,
                          as_text: bool = False) -> str:
        """Save the current step, then export it as a serving bundle
        (serving/export.py) -> the versioned bundle path."""
        from wide_deep_tpu_torch.serving.export import export_savedmodel
        self._trainer.save()
        base = os.path.dirname(self._trainer.model_dir)
        return export_savedmodel(
            self._trainer.config, export_dir,
            model_type=self._trainer.model_type,
            model_dir=base, model_version=model_version, as_text=as_text,
            n_classes=self._trainer.n_classes)

    @property
    def global_step(self) -> int:
        return self._trainer.global_step


class WideAndDeepClassifier(_EstimatorBase):
    """Joint wide+deep classifier (reference joint.py:272-433).

    model_type: 'wide' | 'deep' | 'wide_deep'; all model hyper-parameters
    come from the Config (conf/model.yaml), exactly like
    build_custom_estimator.
    """

    def __init__(self, model_dir: str, model_type: str = "wide_deep",
                 n_classes: int = 2, config: Optional[Config] = None,
                 overrides: Optional[Dict[str, Any]] = None, device=None):
        config = config or Config()
        super().__init__(Trainer(config, model_type=model_type,
                                 model_dir=model_dir, n_classes=n_classes,
                                 overrides=overrides, device=device))


class MultiDNNClassifier(_EstimatorBase):
    """Standalone multi-tower deep classifier (reference dnn.py:298-443):
    N towers with their own hidden_units/connected modes, logits summed,
    a single optimizer (default Adagrad lr 0.05)."""

    def __init__(self, model_dir: str,
                 hidden_units_list: List[List[int]],
                 connected_mode_list: Optional[List[Any]] = None,
                 n_classes: int = 2, config: Optional[Config] = None,
                 overrides: Optional[Dict[str, Any]] = None, device=None):
        config = config or Config()
        # override the deep arm structure through the model conf
        patched = _PatchedModelConfig(
            config, {"dnn_hidden_units": [list(h) for h in hidden_units_list],
                     "dnn_connected_mode": connected_mode_list or "simple"})
        super().__init__(Trainer(patched, model_type="deep",
                                 model_dir=model_dir, n_classes=n_classes,
                                 overrides=overrides, device=device))


class _PatchedModelConfig(Config):
    """Config view with model.yaml keys overridden in memory."""

    def __init__(self, base: Config, model_overrides: Dict[str, Any]):
        super().__init__(base.conf_dir)
        self._model_overrides = model_overrides

    @property
    def model(self) -> Dict[str, Any]:
        out = dict(Config.model.fget(self))
        out.update(self._model_overrides)
        return out


def build_custom_estimator(model_dir: str, model_type: str,
                           config: Optional[Config] = None, device=None
                           ) -> WideAndDeepClassifier:
    """The main construction path (reference build_estimator.py:264-294)."""
    return WideAndDeepClassifier(model_dir, model_type, config=config,
                                 device=device)


def build_estimator(model_dir: str, model_type: str,
                    config: Optional[Config] = None,
                    device=None) -> _EstimatorBase:
    """Canned-defaults construction (reference build_estimator.py:201-261):
    wide -> FTRL(lr=min(0.005, 1/sqrt(n_wide_columns)), l1=.5, l2=1);
    deep -> ProximalAdagrad(lr=.1, l1=.1, l2=.1); wide_deep -> both."""
    config = config or Config()
    n_wide_cols = (len(config.read_feature_conf())
                   + len(config.read_cross_feature_conf()))
    wide_lr = min(0.005, 1.0 / math.sqrt(max(n_wide_cols, 1)))
    overrides = {
        "linear_optimizer": {
            "name": "Ftrl", "learning_rate": wide_lr,
            "l1_regularization_strength": 0.5,
            "l2_regularization_strength": 1.0},
        "linear_decay_rate": 1.0,
        "dnn_optimizer": {
            "name": "ProximalAdagrad", "learning_rate": 0.1,
            "l1_regularization_strength": 0.1,
            "l2_regularization_strength": 0.1},
        "dnn_decay_rate": 1.0,
    }
    patched = _PatchedModelConfig(config, overrides)
    return WideAndDeepClassifier(model_dir, model_type, config=patched,
                                 device=device)
