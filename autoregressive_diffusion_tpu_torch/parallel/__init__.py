from .mesh import (Mesh, all_reduce_grads, check_replica_consistency, create_mesh, full_tensors,
                   gather_batch, gather_to_host, local_shard, param_sharding, seq_slice,
                   shard_train_state, train_state_leaves, unshard_train_state)
from .collectives import (copy_to_model, exchange_halo, fsdp_gather, gather_kv, gather_model,
                          gather_model_partial)
from .launch import run_local_ranks
