from .mesh import (Mesh, all_reduce_grads, check_replica_consistency, create_mesh, gather_batch,
                   seq_slice)
from .collectives import exchange_halo, gather_kv
from .launch import run_local_ranks
