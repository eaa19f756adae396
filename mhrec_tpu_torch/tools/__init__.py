"""Offline tools (port of ``mhrec_tpu/tools``): the prior-dictionary
builders (``clustering``, numpy and scipy) and ``convert_priors``. Nothing
on the training or serving path imports them."""
