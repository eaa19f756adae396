from mhrec_tpu_torch.data.interaction import InteractionData  # noqa: F401
from mhrec_tpu_torch.data.loaders import build_dataloader, build_eval_dataloaders  # noqa: F401
