"""Data parallelism on ``torch.distributed``: one rank a device, each holding
its rows of the global batch, whose step equals one process on that batch
(global BatchNorm statistics, loss normalizers and gradients:
``collectives.py``). The port of ``mm_training_tpu/parallel`` without the
TPU mesh (``make_mesh``, ``batch_sharding``, ``replicated``, the model axis
and ``dryrun.py``)."""
from .collectives import (COUNTS, all_reduce_buckets, all_reduce_sum, broadcast_buckets,
                          reset_counts)
from .mesh import process_batch_bounds, shard_batch
from .multihost import (active, all_gather_object, barrier, initialize, is_main_process,
                        process_count, process_index)

__all__ = ['COUNTS', 'active', 'all_gather_object', 'all_reduce_buckets', 'all_reduce_sum',
           'barrier', 'broadcast_buckets', 'initialize', 'is_main_process',
           'process_batch_bounds', 'process_count', 'process_index', 'reset_counts', 'shard_batch']
