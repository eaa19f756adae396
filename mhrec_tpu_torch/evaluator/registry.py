"""Metric registry: introspects the metrics module and records what each
metric needs (reference ``REC/evaluator/register.py``)."""

from __future__ import annotations

import inspect
from typing import Dict, List


def _cluster_info():
    import mhrec_tpu_torch.evaluator.metrics as metrics_module

    smaller_m: List[str] = []
    m_dict: Dict[str, type] = {}
    m_info: Dict[str, List[str]] = {}
    m_types: Dict[str, object] = {}
    for name, cls in inspect.getmembers(
        metrics_module,
        lambda x: inspect.isclass(x) and x.__module__ == metrics_module.__name__,
    ):
        key = name.lower()
        if not hasattr(cls, "metric_need") or not hasattr(cls, "metric_type"):
            continue
        m_dict[key] = cls
        m_info[key] = cls.metric_need
        m_types[key] = cls.metric_type
        if getattr(cls, "smaller", False):
            smaller_m.append(key)
    return smaller_m, m_info, m_types, m_dict


class _Lazy:
    """Defer metric-module import (metrics import numpy only, but avoid
    import cycles with config)."""

    _computed = None

    @classmethod
    def get(cls):
        if cls._computed is None:
            cls._computed = _cluster_info()
        return cls._computed


class _LazyList:
    def __init__(self, idx):
        self._idx = idx

    def _val(self):
        return _Lazy.get()[self._idx]

    def __iter__(self):
        return iter(self._val())

    def __contains__(self, item):
        return item in self._val()

    def __getitem__(self, item):
        return self._val()[item]

    def keys(self):
        return self._val().keys()

    def items(self):
        return self._val().items()


smaller_metrics = _LazyList(0)
metric_information = _LazyList(1)
metric_types = _LazyList(2)
metrics_dict = _LazyList(3)


class Register:
    """Records which eval resources the configured metrics need."""

    def __init__(self, config):
        self.config = config
        self.metrics = [m.lower() for m in (config["metrics"] or [])]
        shared = [m.lower() for m in (config["shared_metrics"] or [])]
        self._needs = set()
        for metric in self.metrics + shared:
            if metric not in metric_information.keys():
                raise ValueError(f"Unknown metric {metric!r}")
            for info in metric_information[metric]:
                self._needs.add(info)

    def has_metric(self, metric: str) -> bool:
        return metric.lower() in self.metrics

    def need(self, key: str) -> bool:
        return key in self._needs
