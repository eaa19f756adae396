from mhrec_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    fsdp_params,
    RowShard,
    init_distributed,
    make_mesh,
    shard_identical,
    zero_owners,
)
