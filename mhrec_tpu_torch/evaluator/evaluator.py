"""Evaluator: instantiates configured metrics and runs them over a
DataStruct for a given prediction horizon (reference
``REC/evaluator/evaluator.py``). ``pred_len == -1`` selects the shared
(horizon-independent) metrics such as Entropy."""

from __future__ import annotations

from collections import OrderedDict

from mhrec_tpu_torch.evaluator.registry import metrics_dict


class Evaluator:
    def __init__(self, config):
        self.config = config
        self.metrics = [m.lower() for m in (config["metrics"] or [])]
        self.shared_metrics = [m.lower() for m in (config["shared_metrics"] or [])]
        self.metric_class = {
            m: metrics_dict[m](config) for m in self.metrics + self.shared_metrics
        }

    def evaluate(self, dataobject, pred_len=1):
        result = OrderedDict()
        names = self.shared_metrics if pred_len == -1 else self.metrics
        for metric in names:
            result.update(self.metric_class[metric].calculate_metric(dataobject, pred_len=pred_len))
        return result
