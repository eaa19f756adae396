from mhrec_tpu_torch.evaluator.registry import Register, metrics_dict, smaller_metrics  # noqa: F401
from mhrec_tpu_torch.evaluator.collector import Collector, DataStruct  # noqa: F401
from mhrec_tpu_torch.evaluator.evaluator import Evaluator  # noqa: F401
