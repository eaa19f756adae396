from mhrec_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    RowShard,
    init_distributed,
    make_mesh,
    zero_owners,
)
