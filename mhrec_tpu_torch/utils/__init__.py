from mhrec_tpu_torch.utils.logger import init_logger, set_color  # noqa: F401
from mhrec_tpu_torch.utils.misc import init_seed, resolve_device  # noqa: F401
from mhrec_tpu_torch.utils.enums import InputType, EvaluatorType  # noqa: F401
