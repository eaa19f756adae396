from mhrec_tpu_torch.trainer.trainer import Trainer  # noqa: F401
