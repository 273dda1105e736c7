"""Data and model parallelism on ``torch.distributed``: one rank a device,
laid out as the JAX package's (model, data) mesh (``mesh.py``). Data ranks
hold their rows of the global batch, and a step equals one process on that
batch (global BatchNorm statistics, loss normalizers and gradients:
``collectives.py``); model ranks of the same rows hold W shards of the
head's BEV (``spatial.py``). ``dryrun.py`` runs one train step over a world
of ranks, the harness of the equivalence checks. The port of
``mm_training_tpu/parallel``."""
from .collectives import (COUNTS, all_gather, all_reduce_buckets, all_reduce_sum,
                          broadcast_buckets, reset_counts)
from .mesh import (check_layout, current_mesh, data_group, data_index, data_parallel_size, make_mesh,
                   mesh_layout, model_axis, model_index, once, process_batch_bounds,
                   reset_mesh, shard_batch)
from .multihost import (active, all_gather_object, barrier, initialize, is_main_process,
                        process_count, process_index)

__all__ = ['COUNTS', 'active', 'all_gather', 'all_gather_object', 'all_reduce_buckets',
           'all_reduce_sum', 'barrier', 'broadcast_buckets', 'check_layout', 'current_mesh', 'data_group',
           'data_index', 'data_parallel_size', 'initialize', 'is_main_process', 'make_mesh',
           'mesh_layout', 'model_axis', 'model_index', 'once', 'process_batch_bounds',
           'process_count', 'process_index', 'reset_counts', 'reset_mesh', 'shard_batch']
