"""Several ranks on one pair: the clouds point-sharded over a
``torch.distributed`` process group (counterpart of
``piecewise_icp_tpu/parallel/``)."""

from .distributed import (gather_rows, initialize_worker, is_multiprocess,
                          launch, run_on_rank)
from .sharded import ShardGroup, make_group

__all__ = ["ShardGroup", "gather_rows", "initialize_worker", "is_multiprocess",
           "launch", "make_group", "run_on_rank"]
