"""The port's hand-written CUDA kernels and their wrappers. Each wrapper
counts its kernel's launches in its ``launches`` attribute
(``launch_counts``)."""


def kernel_wrappers():
    """Every kernel wrapper of the port."""
    from mhrec_tpu_torch.ops import hstu_attention_cuda as K
    from mhrec_tpu_torch.ops.packed_attention_cuda import packed_attn_bwd, packed_attn_fwd
    from mhrec_tpu_torch.ops.row_adam_cuda import row_adamw

    return (K.hstu_stu_gated_fwd, K.hstu_attn_fwd, K.hstu_stu_gated_bwd, K.hstu_attn_bwd,
            row_adamw, packed_attn_fwd, packed_attn_bwd)


def launch_counts():
    """{wrapper name: launches so far} of every kernel of the port."""
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
