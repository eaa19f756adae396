from mhrec_tpu_torch.config.config import Config, convert_str, load_yaml  # noqa: F401
